"""GNN gather-scale-scatter: ``out[n] = Σ_{dst[e] = n} rad[e] · feat[src[e]]``.

Replaces ``segment_spmm_pallas`` (``_seg_kernel``), whose sequential grid
walks the edges one at a time and accumulates into the output row that the
sorted ``dst`` steers.  The CUDA kernel (``csrc/segment_spmm.cu``) gives
each warp 32 destination rows: it finds its first edge by
searching the sorted ``dst`` itself (no offsets pass) and walks on until
an edge's ``dst`` leaves its rows, summing each row's edges in ascending
edge order (the TPU grid's order) with no atomics, eight feat rows in
flight, with 16-byte loads where :func:`vector_width` allows them.

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
    """(n_out + 1,) int32: the edges of row ``n`` are ``[off[n], off[n+1])``
    (the CSR row pointer; the kernel finds its rows' edges itself)."""
    rows = torch.arange(n_out + 1, dtype=dst.dtype, device=dst.device)
    return torch.searchsorted(dst, rows, out_int32=True)


def vector_width(d: int, *ptrs: int) -> int:
    """Floats per load of the kernel: 4 (16-byte loads) when ``d % 4 == 0``
    and every pointer is 16-byte aligned, else 1."""
    return 4 if d % 4 == 0 and all(p % 16 == 0 for p in ptrs) else 1


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
    d = feat.shape[1]
    out = torch.empty((n_out, d), dtype=torch.float32, device=feat.device)
    lib = _build.lib(NAME)
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_segment_spmm(
            src.data_ptr(), dst.data_ptr(), feat.data_ptr(), rad.data_ptr(),
            out.data_ptr(), n_out, e, d,
            vector_width(d, feat.data_ptr(), out.data_ptr()), stream)
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
