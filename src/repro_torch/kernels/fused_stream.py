"""LC-RWMD phase 2 folded into a streaming per-query top-k.

The CUDA kernels are ``csrc/fused_topk.cu`` (they replace the TPU kernel
``repro.kernels.fused_stream.fused_lc_rwmd_topk_pallas``, whose phase 1 is
the separate phase-1 kernel here): a per-CTA SpMM + k-smallest carry over
contiguous doc ranges, then pairwise merges of the partial lists.  No
(n, B) tensor is written.  :func:`phase2_topk_plain` is the same function
in plain PyTorch: the resident rows scanned in ``row_block`` slabs, each
slab's (R, B) distances folded into a :class:`StreamingTopK` carry.

Both order candidates by ``(distance, doc id)`` and return ``(dists (B, k),
ids (B, k))``, ascending, ``k = min(k, n_real)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.topk import StreamingTopK
from repro_torch.kernels import _build
from repro_torch.kernels.spmm_ell import spmm_ell_plain

NAME = "fused_topk"
K_MAX = 128  # largest k the kernel's shared-memory carry takes
_CTAS_PER_SM = 2


def phase2_topk_plain(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                      k: int, *, n_real: int | None = None,
                      row_block: int = 128):
    """Plain PyTorch version: ids/w (n, h), z (v, B) → ((B, k), (B, k))."""
    n = ids.shape[0] if n_real is None else min(n_real, ids.shape[0])
    b = z.shape[1]
    stk = StreamingTopK(min(k, n))
    carry = stk.init(b, device=z.device)
    r = max(1, min(row_block, n))
    for lo in range(0, n, r):
        hi = min(lo + r, n)
        d_blk = spmm_ell_plain(ids[lo:hi], w[lo:hi], z)            # (R, B)
        rows = torch.arange(lo, hi, dtype=torch.int32, device=z.device)
        carry = stk.update_cols(carry, d_blk, rows)
    return carry.dists, carry.indices


def phase2_topk_cuda(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                     k: int, *, n_real: int | None = None):
    """Launch the CUDA kernels: ids int32 / w f32 (n, h), z f32 (v, B)."""
    _build.require(ids, torch.int32, 2, "ids")
    _build.require(w, torch.float32, 2, "w")
    _build.require(z, torch.float32, 2, "z")
    if ids.shape != w.shape:
        raise ValueError(f"ids {tuple(ids.shape)} != w {tuple(w.shape)}")
    n, h = ids.shape
    n_real = n if n_real is None else min(n_real, n)
    b = z.shape[1]
    kk = min(k, n_real)
    if kk < 1:
        raise ValueError(f"k must be positive and n_real > 0, got k={k}, "
                         f"n_real={n_real}")
    if kk > K_MAX:
        raise ValueError(f"k={kk} exceeds the fused top-k kernel's maximum "
                         f"of {K_MAX}")
    if b > 65535:
        raise ValueError(f"at most 65535 queries per call, got {b}")
    dev = z.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ctas = max(1, min(-(-n_real // 64), n_sm * _CTAS_PER_SM))
    per_cta = -(-n_real // n_ctas)
    rows = -(-per_cta // 8) * 8   # rows per CTA, a multiple of the 8-row step
    n_ctas = -(-n_real // rows)
    vals = torch.empty((n_ctas, b, kk), dtype=torch.float32, device=dev)
    idx = torch.empty((n_ctas, b, kk), dtype=torch.int32, device=dev)
    lib = _build.lib(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_fused_topk_partial(
            ids.data_ptr(), w.data_ptr(), z.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), n, n_real, h, b, kk, rows, stream)
        _build.check(code, NAME)
        while vals.shape[0] > 1:
            n_out = -(-vals.shape[0] // 2)
            v2 = torch.empty((n_out, b, kk), dtype=torch.float32, device=dev)
            i2 = torch.empty((n_out, b, kk), dtype=torch.int32, device=dev)
            code = lib.launch_topk_merge(
                vals.data_ptr(), idx.data_ptr(), v2.data_ptr(),
                i2.data_ptr(), vals.shape[0], b, kk, stream)
            _build.check(code, NAME + "_merge")
            vals, idx = v2, i2
    _build.LAUNCHES[NAME] += 1
    return vals[0], idx[0]


def phase2_topk(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor, k: int,
                *, n_real: int | None = None, row_block: int = 128):
    """Streaming phase-2 top-k: the kernels on CUDA, the plain fold on CPU.

    ``row_block`` is the plain fold's slab height; the kernel picks its own
    doc ranges.  The result does not depend on either.
    """
    if z.is_cuda:
        return phase2_topk_cuda(ids, w, z, k, n_real=n_real)
    if z.device.type == "cpu":
        return phase2_topk_plain(ids, w, z, k, n_real=n_real,
                                 row_block=row_block)
    raise ValueError(f"unsupported device {z.device}")
