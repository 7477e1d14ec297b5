"""Device policy: the card by default, the CPU only when asked for.

Importing this module sets the backend flags the port's float32 products
rely on: no TF32 in matmuls or cuDNN, and bf16 products summed in float32
(as the reference's dots are).  Every torch-backed module of the port
imports it, so the flags hold before any GEMM runs.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises.

    There is no quiet move to the CPU: a caller that wants the plain
    PyTorch versions of the kernels passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    return dev
