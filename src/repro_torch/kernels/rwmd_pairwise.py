"""Quadratic RWMD (the paper's baseline, Sec. III), and its swapped
direction alone.

The CUDA kernel is ``csrc/rwmd_pairwise.cu`` (it replaces the TPU kernel
``repro.kernels.rwmd_pairwise.rwmd_pairwise_pallas``): a 128 x 128
register-tiled GEMM of the valid (doc, word) rows against the valid
(query, word) columns only, listed on the device, reading the embedding
rows by id, with the row and column minima folded in its epilogue.  The
(n, h1, m) gather the TPU wrapper built never exists.

Two modes of the one kernel:

* :func:`rwmd_pairwise`: (n, B) f32 ``max(d12, d21)`` per (resident doc,
  query), a masked minimum over nothing counted as 3.4e38 (so an empty
  resident doc or an empty query gives about 3.4e38, and 0 on the empty
  side).  :func:`rwmd_pairwise_plain` is the same function in plain
  PyTorch, gathering ``_PLAIN_DOCS`` docs at a time.
* :func:`rwmd_d21`: (n, B) f32 ``d21`` alone, the symmetric LC-RWMD's
  swapped direction: for each query word, the distance to the nearest
  valid word of the resident doc, summed with the query's weights.  An
  empty resident doc gives +inf (0 against an empty query); padded query
  words add nothing.  :func:`rwmd_d21_plain` is the same function, with
  the slab fold's own formulas (``core/lc_rwmd.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import bf16_round, safe_sqrt, sq_dists
from repro_torch.kernels import _build

NAME = "rwmd_pairwise"
D21_NAME = "rwmd_d21"
BIG = 3.4e38
QUERY_GROUP = 32   # queries per group of the kernel's grid (csrc QG)
TILE_ROWS = 128    # valid (doc, word) rows per tile of the kernel
TILE_COLS = 128    # valid (query, word) columns per tile of the kernel
TILE_DOCS = 16     # docs per row tile of the kernel (csrc DMAX)
_CTAS_PER_SM = 2
_PLAIN_DOCS = 2048  # docs per (docs, h1, B, h2) block of the plain version


def rwmd_pairwise_plain(emb: torch.Tensor, r_ids: torch.Tensor,
                        r_w: torch.Tensor, q_ids: torch.Tensor,
                        q_w: torch.Tensor, *,
                        bf16_matmul: bool = False) -> torch.Tensor:
    """Plain PyTorch version: emb (v, m), r_ids/r_w (n, h1), q_ids/q_w (B, h2)."""
    n, h1 = r_ids.shape
    b, h2 = q_ids.shape
    t2 = emb[q_ids.reshape(-1).long()]                       # (B*h2, m)
    b2 = (t2 * t2).sum(dim=-1)[None, :]
    m2 = (q_w > 0).reshape(1, 1, b, h2)
    w2 = torch.where(q_w > 0, q_w, torch.zeros_like(q_w))   # (B, h2)
    t2m = bf16_round(t2) if bf16_matmul else t2
    out = torch.empty((n, b), dtype=torch.float32, device=emb.device)
    for lo in range(0, n, _PLAIN_DOCS):
        hi = min(lo + _PLAIN_DOCS, n)
        t1 = emb[r_ids[lo:hi].reshape(-1).long()]            # (R*h1, m)
        a2 = (t1 * t1).sum(dim=-1)[:, None]
        t1m = bf16_round(t1) if bf16_matmul else t1
        sq = torch.clamp(a2 + b2 - 2.0 * (t1m @ t2m.T), min=0.0)
        c = torch.sqrt(sq).reshape(hi - lo, h1, b, h2)
        w1 = r_w[lo:hi]
        m1 = (w1 > 0)[:, :, None, None]
        row_min = torch.where(m2, c, BIG).amin(dim=3)        # (R, h1, B)
        d12 = (w1[:, :, None] * torch.where(
            m1[..., 0], row_min, 0.0)).sum(dim=1)            # (R, B)
        col_min = torch.where(m1, c, BIG).amin(dim=1)        # (R, B, h2)
        d21 = (col_min * w2[None]).sum(dim=-1)               # (R, B)
        out[lo:hi] = torch.maximum(d12, d21)
    return out


def d21_from_min(z2: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """(B, R) ``Σ_q w2[q] · z2[:, q]`` over the valid query words only.

    z2 (B, h2, R): each query word's distance to the nearest valid word of
    each of R resident docs (+inf for an empty doc).  A padded word adds 0,
    where ``0 · inf`` would give NaN.
    """
    return torch.where((q_w > 0)[:, :, None], q_w[:, :, None] * z2,
                       torch.zeros((), device=z2.device)).sum(dim=1)


def rwmd_d21_plain(emb: torch.Tensor, r_ids: torch.Tensor,
                   r_w: torch.Tensor, q_ids: torch.Tensor, q_w: torch.Tensor,
                   *, bf16_matmul: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the d21 mode: (n, B) f32."""
    n, h1 = r_ids.shape
    b, h2 = q_ids.shape
    t_q = emb[q_ids.reshape(-1).long()]                       # (B*h2, m)
    out = torch.empty((n, b), dtype=torch.float32, device=emb.device)
    for lo in range(0, n, _PLAIN_DOCS):
        hi = min(lo + _PLAIN_DOCS, n)
        sq = sq_dists(t_q, emb[r_ids[lo:hi].reshape(-1).long()],
                      bf16_matmul=bf16_matmul)                # (B*h2, R*h1)
        sq.masked_fill_(~(r_w[lo:hi] > 0).reshape(1, -1), float("inf"))
        z2 = safe_sqrt(sq.reshape(b * h2, hi - lo, h1).amin(dim=2))
        out[lo:hi] = d21_from_min(z2.reshape(b, h2, hi - lo), q_w).T
    return out


def _launch(emb: torch.Tensor, r_ids: torch.Tensor, r_w: torch.Tensor,
            q_ids: torch.Tensor, q_w: torch.Tensor, *, full: bool,
            bf16_matmul: bool) -> torch.Tensor:
    """The kernel in either mode: emb f32 (v, m), ids int32, weights f32."""
    _build.require(emb, torch.float32, 2, "emb")
    _build.require(r_ids, torch.int32, 2, "r_ids")
    _build.require(r_w, torch.float32, 2, "r_w")
    _build.require(q_ids, torch.int32, 2, "q_ids")
    _build.require(q_w, torch.float32, 2, "q_w")
    if r_ids.shape != r_w.shape or q_ids.shape != q_w.shape:
        raise ValueError("ids and weights must have the same shape")
    n, h1 = r_ids.shape
    b, h2 = q_ids.shape
    m = emb.shape[1]
    if n * h1 >= 2 ** 31 or b * h2 >= 2 ** 31:
        raise ValueError("the kernel lists the word slots with int32 indices: "
                         f"n*h1 = {n * h1} and B*h2 = {b * h2} must stay below "
                         "2^31")
    dev = emb.device
    groups = -(-b // QUERY_GROUP)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = max(1, min(_CTAS_PER_SM * n_sm // groups, -(-n * h1 // 128)))
    i32 = dict(dtype=torch.int32, device=dev)
    cnt = torch.empty(n, **i32)
    doc_start = torch.empty(n + 1, **i32)
    rows = torch.empty(n * h1, **i32)
    cols = torch.empty(b * h2, **i32)
    gcol = torch.empty(groups + 1, **i32)
    carry_col = torch.empty(groups * ctas * QUERY_GROUP * h2, **i32)
    carry_d12 = torch.empty(groups * ctas * QUERY_GROUP, dtype=torch.float32,
                            device=dev)
    out = torch.empty((n, b), dtype=torch.float32, device=dev)
    lib = _build.lib(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_rwmd_pairwise(
            emb.data_ptr(), r_ids.data_ptr(), r_w.data_ptr(), q_ids.data_ptr(),
            q_w.data_ptr(), cnt.data_ptr(), doc_start.data_ptr(),
            rows.data_ptr(), cols.data_ptr(), gcol.data_ptr(),
            carry_col.data_ptr(), carry_d12.data_ptr(), out.data_ptr(), n, b,
            h1, h2, m, ctas, int(full), int(bf16_matmul), stream)
    _build.check(code, NAME if full else D21_NAME)
    return out


def rwmd_pairwise_cuda(emb: torch.Tensor, r_ids: torch.Tensor,
                       r_w: torch.Tensor, q_ids: torch.Tensor,
                       q_w: torch.Tensor, *,
                       bf16_matmul: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel, max(d12, d21): emb f32 (v, m), ids int32,
    weights f32."""
    out = _launch(emb, r_ids, r_w, q_ids, q_w, full=True,
                  bf16_matmul=bf16_matmul)
    _build.LAUNCHES[NAME] += 1
    return out


def rwmd_d21_cuda(emb: torch.Tensor, r_ids: torch.Tensor, r_w: torch.Tensor,
                  q_ids: torch.Tensor, q_w: torch.Tensor, *,
                  bf16_matmul: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel in its d21 mode (no row minima, no d12)."""
    out = _launch(emb, r_ids, r_w, q_ids, q_w, full=False,
                  bf16_matmul=bf16_matmul)
    _build.LAUNCHES[D21_NAME] += 1
    return out


def rwmd_pairwise(emb: torch.Tensor, r_ids: torch.Tensor, r_w: torch.Tensor,
                  q_ids: torch.Tensor, q_w: torch.Tensor, *,
                  bf16_matmul: bool = False) -> torch.Tensor:
    """Quadratic RWMD (n, B): the kernel on CUDA, the plain version on CPU."""
    if emb.is_cuda:
        return rwmd_pairwise_cuda(emb, r_ids, r_w, q_ids, q_w,
                                  bf16_matmul=bf16_matmul)
    if emb.device.type == "cpu":
        return rwmd_pairwise_plain(emb, r_ids, r_w, q_ids, q_w,
                                   bf16_matmul=bf16_matmul)
    raise ValueError(f"unsupported device {emb.device}")


def rwmd_d21(emb: torch.Tensor, r_ids: torch.Tensor, r_w: torch.Tensor,
             q_ids: torch.Tensor, q_w: torch.Tensor, *,
             bf16_matmul: bool = False) -> torch.Tensor:
    """The swapped direction d21 (n, B): the kernel's d21 mode on CUDA, the
    plain version on CPU."""
    if emb.is_cuda:
        return rwmd_d21_cuda(emb, r_ids, r_w, q_ids, q_w,
                             bf16_matmul=bf16_matmul)
    if emb.device.type == "cpu":
        return rwmd_d21_plain(emb, r_ids, r_w, q_ids, q_w,
                              bf16_matmul=bf16_matmul)
    raise ValueError(f"unsupported device {emb.device}")
