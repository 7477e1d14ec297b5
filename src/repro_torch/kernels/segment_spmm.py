"""GNN gather-scale-scatter: ``out[n] = Σ_{dst[e] = n} rad[e] · feat[src[e]]``.

Replaces ``segment_spmm_pallas`` (``_seg_kernel``), whose sequential grid
walks the edges one at a time and accumulates into the output row that the
sorted ``dst`` steers.  The CUDA kernel (``csrc/segment_spmm.cu``) gives
each destination row one warp, which sums that row's edges in ascending
edge order (the TPU grid's order) with no atomics; the wrapper turns the
sorted ``dst`` into row offsets.

Contract, as in the reference's ``ops.segment_spmm``: ``dst`` is sorted
ascending, padding edges carry ``rad = 0``, rows with no edge are 0, and
the output is ``(n_out, D)`` float32 (the TPU's 128-lane padding of ``D``
has no counterpart here).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "segment_spmm"


def segment_spmm_plain(src: torch.Tensor, dst: torch.Tensor,
                       feat: torch.Tensor, rad: torch.Tensor,
                       n_out: int) -> torch.Tensor:
    """Plain PyTorch version: the (E, D) messages, then an indexed add (in
    edge order on the CPU; with atomics, in no fixed order, on the card)."""
    msg = feat[src.long()].mul_(rad[:, None])   # one (E, D) tensor, scaled in place
    out = torch.zeros((n_out, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    return out.index_add_(0, dst.long(), msg)


def row_offsets(dst: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out + 1,) int32: the edges of row ``n`` are ``[off[n], off[n+1])``."""
    rows = torch.arange(n_out + 1, dtype=dst.dtype, device=dst.device)
    return torch.searchsorted(dst, rows, out_int32=True)


def segment_spmm_cuda(src: torch.Tensor, dst: torch.Tensor,
                      feat: torch.Tensor, rad: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """Launch the CUDA kernel: src/dst int32 (E,), dst sorted, feat f32 (N, D),
    rad f32 (E,)."""
    _build.require(src, torch.int32, 1, "src")
    _build.require(dst, torch.int32, 1, "dst")
    _build.require(feat, torch.float32, 2, "feat")
    _build.require(rad, torch.float32, 1, "rad")
    e = src.shape[0]
    if dst.shape[0] != e or rad.shape[0] != e:
        raise ValueError(f"src {e}, dst {dst.shape[0]} and rad {rad.shape[0]} "
                         "edges differ")
    if e > 2**31 - 1:
        raise ValueError(f"at most 2**31 - 1 edges, got {e}")
    n, d = feat.shape
    off = row_offsets(dst, n_out)
    out = torch.empty((n_out, d), dtype=torch.float32, device=feat.device)
    lib = _build.lib(NAME)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_segment_spmm(
            src.data_ptr(), off.data_ptr(), feat.data_ptr(), rad.data_ptr(),
            out.data_ptr(), n_out, d, stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def segment_spmm(src: torch.Tensor, dst: torch.Tensor, feat: torch.Tensor,
                 rad: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out, D) f32: the kernel on CUDA, the plain version on CPU."""
    if feat.is_cuda:
        return segment_spmm_cuda(src, dst, feat, rad, n_out)
    if feat.device.type == "cpu":
        return segment_spmm_plain(src, dst, feat, rad, n_out)
    raise ValueError(f"unsupported device {feat.device}")
