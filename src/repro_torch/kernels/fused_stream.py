"""The fused LC-RWMD kernels: phase 2 folded into a streaming per-query
top-k, and one vocab chunk's phase 1 → phase 2.

Vocab chunk: the CUDA kernels are ``csrc/fused_chunk.cu`` (they replace
the TPU kernel ``repro.kernels.fused_stream.fused_lc_rwmd_chunk_pallas``):
per slab of up to ``CHUNK_COLS`` queries, one launch makes the chunk's
squared Z over the valid query words (B1's GEMM) into a scratch, and a
second, one CTA of 32 warps per SM, stages Z into shared memory (or reads
it from L2 where it does not fit) while every doc row adds its in-chunk
slots into D, in place.  :func:`fused_chunk_plain` is the same function
in plain PyTorch.

Top-k:

The CUDA kernels are ``csrc/fused_topk.cu`` (they replace the TPU kernel
``repro.kernels.fused_stream.fused_lc_rwmd_topk_pallas``, whose phase 1 is
the separate phase-1 kernel here): each CTA walks a contiguous doc range
(:func:`cta_rows`) in steps of ``STEP_ROWS`` rows, filters each step's
(rows, queries) tile against a per-query threshold into buffers of
``FLUSH_CAP`` candidates, and flushes them into a sorted k-smallest carry
(in shared memory up to k = 128, in the partials' global memory above
it: any k; a CTA keeps at most as many entries as it has rows, see
:func:`list_widths`); then pairwise merges of the partial lists.  No (n, B)
tensor is written.  :func:`phase2_topk_plain` is the same function in
plain PyTorch: the resident rows scanned in ``row_block`` slabs, each
slab's (R, B) distances folded into a :class:`StreamingTopK` carry.

Three optional operands act on each (row, query) entry before it is
ranked, as the reference's jnp fold applies them: ``d21`` (n, B), maxed in
(the symmetric bound's swapped direction; NaN-propagating, as
``torch.maximum``); ``row_valid`` (n,) bool, whose False rows are left out
for every query (tombstones); ``q_gid`` (B,), whose pair (row
``q_gid[j]``, query j) is left out (self-exclusion).  A left-out entry is
an unfilled slot, never ranked, so it is told apart from a real +inf.

Both order candidates by ``(distance, doc id)`` in ``torch.sort``'s order
(+inf after every finite value, NaN after +inf; the kernel compares an
order-preserving unsigned key of each float) and return ``(dists (B, k),
ids (B, k))``, ascending, ``k = min(k, n_real)``; the two agree in every
slot, non-finite ones included.  Where fewer than k entries are left in
for a query, the unfilled tail is (+inf, -1) from the plain fold and
(3.4e38, -1) from the kernel; both rank after every real entry
(:func:`repro_torch.core.topk.lex_smallest`).
"""

from __future__ import annotations

import torch

from repro_torch.core.topk import StreamingTopK, masked_entries
from repro_torch.kernels import _build
from repro_torch.kernels.lc_rwmd_phase1 import phase1_sq_plain
from repro_torch.kernels.spmm_ell import spmm_ell_plain

NAME = "fused_topk"
STEP_ROWS = 32   # doc rows per step of the kernel
FLUSH_CAP = 64   # buffered candidates per query between flushes
_CTAS_PER_SM = 2
_MIN_ROWS = 64   # fewest doc rows per CTA
CHUNK_NAME = "fused_chunk"
CHUNK_COLS = 128       # queries per slab of the vocab-chunk kernels
_PLAIN_ROWS = 65536    # doc rows per (rows, h1, B) gather of the plain version


def phase2_topk_plain(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                      k: int, *, n_real: int | None = None,
                      row_block: int = 128, q_gid: torch.Tensor | None = None,
                      row_valid: torch.Tensor | None = None,
                      d21: torch.Tensor | None = None):
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
        if d21 is not None:
            d_blk = torch.maximum(d_blk, d21[lo:hi])
        carry = stk.update(carry, *masked_entries(
            d_blk.T, rows, None if row_valid is None else row_valid[lo:hi],
            q_gid))
    return carry.dists, carry.indices


def cta_rows(n_real: int, n_sm: int) -> tuple[int, int]:
    """The kernel's doc ranges: (rows per CTA, a multiple of ``STEP_ROWS``;
    number of CTAs), two CTAs per SM where the rows allow."""
    n_ctas = max(1, min(-(-n_real // _MIN_ROWS), n_sm * _CTAS_PER_SM))
    per_cta = -(-n_real // n_ctas)
    rows = -(-per_cta // STEP_ROWS) * STEP_ROWS
    return rows, -(-n_real // rows)


def list_widths(kk: int, rows: int, n_ctas: int) -> list[int]:
    """Entries a query of each level of the kernel's lists: a CTA's partial
    holds ``min(k, rows)`` (it ranks no more rows than that), each pairwise
    merge up to twice its inputs', capped at k.  The last level holds k, and
    no level more than about ``n_real`` entries a query, whatever k is."""
    widths = [min(kk, rows)]
    while n_ctas > 1:
        n_ctas = -(-n_ctas // 2)
        widths.append(min(kk, 2 * widths[-1]))
    return widths


def _optional(x: torch.Tensor | None, dtype: torch.dtype, shape: tuple,
              name: str) -> int:
    """The device pointer of an optional operand (0 for None), checked."""
    if x is None:
        return 0
    _build.require(x, dtype, len(shape), name)
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(x.shape)}")
    return x.data_ptr()


def phase2_topk_cuda(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                     k: int, *, n_real: int | None = None,
                     q_gid: torch.Tensor | None = None,
                     row_valid: torch.Tensor | None = None,
                     d21: torch.Tensor | None = None):
    """Launch the CUDA kernels: ids int32 / w f32 (n, h), z f32 (v, B);
    q_gid int32 (B,), row_valid bool (n,), d21 f32 (n, B), each optional."""
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
    extra = (_optional(row_valid, torch.bool, (n,), "row_valid"),
             _optional(q_gid, torch.int32, (b,), "q_gid"),
             _optional(d21, torch.float32, (n, b), "d21"))
    dev = z.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, n_ctas = cta_rows(n_real, n_sm)
    widths = list_widths(kk, rows, n_ctas)
    vals = torch.empty((n_ctas, b, widths[0]), dtype=torch.float32, device=dev)
    idx = torch.empty((n_ctas, b, widths[0]), dtype=torch.int32, device=dev)
    lib = _build.lib(NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_fused_topk_partial(
            ids.data_ptr(), w.data_ptr(), z.data_ptr(), *extra,
            vals.data_ptr(), idx.data_ptr(), n, n_real, h, z.shape[0], b,
            widths[0], rows, stream)
        _build.check(code, NAME)
        for k_out in widths[1:]:
            n_out = -(-vals.shape[0] // 2)
            v2 = torch.empty((n_out, b, k_out), dtype=torch.float32, device=dev)
            i2 = torch.empty((n_out, b, k_out), dtype=torch.int32, device=dev)
            code = lib.launch_topk_merge(
                vals.data_ptr(), idx.data_ptr(), v2.data_ptr(),
                i2.data_ptr(), vals.shape[0], b, vals.shape[2], k_out, stream)
            _build.check(code, NAME + "_merge")
            vals, idx = v2, i2
    _build.LAUNCHES[NAME] += 1
    return vals[0], idx[0]


def phase2_topk(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor, k: int,
                *, n_real: int | None = None, row_block: int = 128,
                q_gid: torch.Tensor | None = None,
                row_valid: torch.Tensor | None = None,
                d21: torch.Tensor | None = None):
    """Streaming phase-2 top-k: the kernels on CUDA, the plain fold on CPU.

    ``row_block`` is the plain fold's slab height; the kernel picks its own
    doc ranges.  The result does not depend on either.
    """
    if z.is_cuda:
        return phase2_topk_cuda(ids, w, z, k, n_real=n_real, q_gid=q_gid,
                                row_valid=row_valid, d21=d21)
    if z.device.type == "cpu":
        return phase2_topk_plain(ids, w, z, k, n_real=n_real,
                                 row_block=row_block, q_gid=q_gid,
                                 row_valid=row_valid, d21=d21)
    raise ValueError(f"unsupported device {z.device}")


# ---------------------------------------------------------------------------
# One vocab chunk: phase 1 → phase 2, accumulated into D in place
# ---------------------------------------------------------------------------
def chunk_relative(r_ids: torch.Tensor, r_w: torch.Tensor, lo: int,
                   cv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's chunk view of the resident docs: ids made relative to
    the chunk ``[lo, lo + cv)`` and clipped into it, and the weights of the
    slots outside it zeroed."""
    rel = r_ids - lo
    inb = (rel >= 0) & (rel < cv)
    return rel.clamp_(0, cv - 1), r_w * inb


def fused_chunk_plain(emb_c: torch.Tensor, t: torch.Tensor,
                      valid: torch.Tensor, r_ids: torch.Tensor,
                      r_w: torch.Tensor, lo: int, d: torch.Tensor, *,
                      bf16_matmul: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``d += Σ_p w_masked · Z_chunk[ids_rel]``.

    emb_c (cv, m) holds the vocab rows ``[lo, lo + cv)``, t (B, h, m),
    valid (B, h) 0/1, r_ids/r_w (n, h1) the resident docs (vocab ids),
    d (n, B) updated in place and returned.  ``ids_rel``/``w_masked`` are
    :func:`chunk_relative`'s; the (rows, h1, B) gather is taken
    ``_PLAIN_ROWS`` rows at a time.
    """
    cv = emb_c.shape[0]
    z = torch.sqrt(torch.clamp(
        phase1_sq_plain(emb_c, t, valid, bf16_matmul=bf16_matmul), min=0.0))
    n = r_ids.shape[0]
    for r0 in range(0, n, _PLAIN_ROWS):
        r1 = min(r0 + _PLAIN_ROWS, n)
        ids_rel, w_m = chunk_relative(r_ids[r0:r1], r_w[r0:r1], lo, cv)
        d[r0:r1] += spmm_ell_plain(ids_rel, w_m, z)
    return d


def fused_chunk_cuda(emb_c: torch.Tensor, t: torch.Tensor,
                     valid: torch.Tensor, r_ids: torch.Tensor,
                     r_w: torch.Tensor, lo: int, d: torch.Tensor, *,
                     bf16_matmul: bool = False) -> torch.Tensor:
    """Launch the CUDA kernels; ``d`` (n, B) f32 is accumulated in place.

    The kernels read ``r_ids``/``r_w`` as they are and add only the slots
    whose id falls in ``[lo, lo + cv)``: the same sum as the reference's
    chunk-relative ids and zeroed weights.  Any chunk size: Z is read from
    shared memory where the chunk's (cv, slab) floats fit, else from L2.
    """
    _build.require(emb_c, torch.float32, 2, "emb_c")
    _build.require(t, torch.float32, 3, "t")
    _build.require(valid, torch.float32, 2, "valid")
    _build.require(r_ids, torch.int32, 2, "r_ids")
    _build.require(r_w, torch.float32, 2, "r_w")
    _build.require(d, torch.float32, 2, "d")
    cv, m = emb_c.shape
    b, h, m_t = t.shape
    n, h1 = r_ids.shape
    if (m_t != m or tuple(valid.shape) != (b, h)
            or tuple(r_w.shape) != (n, h1) or tuple(d.shape) != (n, b)):
        raise ValueError(
            f"shape mismatch: emb_c {tuple(emb_c.shape)}, t {tuple(t.shape)}, "
            f"valid {tuple(valid.shape)}, r_ids {tuple(r_ids.shape)}, "
            f"r_w {tuple(r_w.shape)}, d {tuple(d.shape)}")
    if n * h1 >= 2 ** 31 or b * h >= 2 ** 31:
        raise ValueError(f"the kernels index slots in int32: n*h1 = {n * h1}, "
                         f"B*h = {b * h}")
    dev = emb_c.device
    lib = _build.lib(CHUNK_NAME)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, b, CHUNK_COLS):
            nq = min(CHUNK_COLS, b - c0)
            zsq = torch.empty((cv, nq), dtype=torch.int32, device=dev)
            code = lib.launch_fused_chunk(
                emb_c.data_ptr(), t[c0:c0 + nq].data_ptr(),
                valid[c0:c0 + nq].data_ptr(), r_ids.data_ptr(),
                r_w.data_ptr(), d.data_ptr() + 4 * c0, zsq.data_ptr(), cv, lo,
                m, nq, h, n, h1, b, int(bf16_matmul), stream)
            _build.check(code, CHUNK_NAME)
            _build.LAUNCHES[CHUNK_NAME] += 2  # chunk_z and chunk_consume
    return d


def fused_chunk(emb_c, t, valid, r_ids, r_w, lo, d, *,
                bf16_matmul: bool = False) -> torch.Tensor:
    """One vocab chunk into D, in place: the kernel on CUDA, plain on CPU."""
    if d.is_cuda:
        return fused_chunk_cuda(emb_c, t, valid, r_ids, r_w, lo, d,
                                bf16_matmul=bf16_matmul)
    if d.device.type == "cpu":
        return fused_chunk_plain(emb_c, t, valid, r_ids, r_w, lo, d,
                                 bf16_matmul=bf16_matmul)
    raise ValueError(f"unsupported device {d.device}")
