"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Nothing here is built or imported from CUDA when the package is imported:
``_build`` compiles ``csrc/*.cu`` at the first launch.
"""
