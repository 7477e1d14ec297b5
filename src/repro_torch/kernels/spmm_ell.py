"""LC-RWMD phase 2: the ELL SpMM ``D[i, j] = Σ_p w[i, p] · Z[ids[i, p], j]``.

The CUDA kernel is ``csrc/spmm_ell.cu`` (it replaces the TPU kernel
``repro.kernels.spmm_ell.spmm_ell_pallas``); :func:`spmm_ell_plain` is the
same function in plain PyTorch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "spmm_ell"


def spmm_ell_plain(ids: torch.Tensor, w: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ids/w (n, h), z (v, B) → (n, B)."""
    return torch.einsum("nh,nhb->nb", w, z[ids.long()])


def spmm_ell_cuda(ids: torch.Tensor, w: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ids int32 / w f32 (n, h), z f32 (v, B)."""
    _build.require(ids, torch.int32, 2, "ids")
    _build.require(w, torch.float32, 2, "w")
    _build.require(z, torch.float32, 2, "z")
    if ids.shape != w.shape:
        raise ValueError(f"ids {tuple(ids.shape)} != w {tuple(w.shape)}")
    n, h = ids.shape
    b = z.shape[1]
    out = torch.empty((n, b), dtype=torch.float32, device=z.device)
    lib = _build.lib(NAME)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_spmm_ell(
            ids.data_ptr(), w.data_ptr(), z.data_ptr(), out.data_ptr(),
            n, h, b, stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def spmm_ell(ids: torch.Tensor, w: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """D (n, B): the kernel on CUDA, the plain version on CPU."""
    if z.is_cuda:
        return spmm_ell_cuda(ids, w, z)
    if z.device.type == "cpu":
        return spmm_ell_plain(ids, w, z)
    raise ValueError(f"unsupported device {z.device}")
