"""LC-RWMD in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch counterpart of the JAX package ``repro``: the same query cascade
(phase 1, ELL SpMM, streaming top-k, Sinkhorn-WMD rerank), the paper's
comparison path, the serving plane (``repro_torch.serving``), and the
transformers' prefill and decode (``repro_torch.models.transformer``: dense
GQA, MLA, MoE, the int8 KV cache) on an NVIDIA H100.
Entry points run on the card unless the caller passes ``device="cpu"``; the
tensors' device then decides the route: CUDA tensors launch the kernels in
``csrc/``, CPU tensors take each kernel's plain PyTorch version.

float32 stays IEEE float32: :mod:`repro_torch.device`, which every
torch-backed module of the port imports, switches TF32 off for matmuls and
cuDNN, and the distance GEMMs refuse to run with it on.

This package imports nothing eagerly (PEP 562), so a spawned ingest worker
that imports ``repro_torch.serving.ingest_pool`` or
``repro_torch.data.vectorizer`` never imports torch.
"""

_EXPORTS = {"resolve_device": "repro_torch.device"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
