"""LC-RWMD in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The PyTorch counterpart of the JAX package ``repro``: the same query cascade
(phase 1, ELL SpMM, streaming top-k, Sinkhorn-WMD rerank) on an NVIDIA H100.
Entry points run on the card unless the caller passes ``device="cpu"``; the
tensors' device then decides the route: CUDA tensors launch the kernels in
``csrc/``, CPU tensors take each kernel's plain PyTorch version.

float32 stays IEEE float32: TF32 is switched off for matmuls and cuDNN when
this package is imported, and the distance GEMMs refuse to run with it on.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
