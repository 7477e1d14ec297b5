"""Linear-Complexity RWMD (the paper's contribution, Sec. IV), in PyTorch.

Decomposes RWMD against a *set* of documents into two linear phases:

  Phase 1:  For a batch of query docs, compute for every vocabulary word the
            distance to the closest word of each query:
            ``Z[w, j] = min_{q in doc_j} ||E[w] - E[q]||``          O(v·h·m)
  Phase 2:  SpMM of the resident ELL matrix with Z:
            ``D1[i, j] = sum_p W1[i,p] * Z[ids1[i,p], j]``          O(n·h)

The symmetric (tighter) bound runs the same two phases with the sets swapped
and takes the elementwise max of ``D1`` and ``D2ᵀ``.

The entry points here are the counterparts of the reference's
``use_kernel=True`` paths: on CUDA tensors phase 1, phase 2, the streaming
top-k and the rerank launch the hand-written kernels (``repro_torch.kernels``),
on CPU tensors their plain versions run.  :func:`phase1_z` and
:func:`phase2_spmm` are the plain formulations (the reference's jnp path).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as topk_lib
from repro_torch.core.distances import safe_sqrt, sq_dists
from repro_torch.data.docs import DocSet
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import rwmd_pairwise as _rw

_INF = float("inf")


def as_f32(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``x`` (numpy or tensor) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


class SegmentTensors(NamedTuple):
    """Device tensors of one resident corpus, as the streaming fold reads them.

    No (n·h1, m) pre-gathered target tensor: the card's routes read ``emb``
    by ``ids`` (the swapped-direction kernel), and the CPU slab fold
    gathers each slab's targets from them.
    """

    emb_r: torch.Tensor     # (v_e, m) restricted embedding rows (phase-1 input)
    r_ids: torch.Tensor     # (n, h1) restricted int32 word ids (ELL)
    r_w: torch.Tensor       # (n, h1) f32 weights (0 at padding slots)
    emb: torch.Tensor       # (v, m) the FULL table (the swapped direction)
    ids: torch.Tensor       # (n, h1) int32 word ids into the full table


def doc_targets(docs: DocSet, emb: torch.Tensor, rows: torch.Tensor):
    """Word embeddings (P, h, m) and weights (P, h) of docs ``rows`` (P,),
    gathered from the full table ``emb`` by the docs' ids."""
    ids = docs.ids.index_select(0, rows)
    t = emb.index_select(0, ids.reshape(-1)).reshape(*ids.shape, -1)
    return t, docs.weights.index_select(0, rows)


# ---------------------------------------------------------------------------
# Phase 1 — vocabulary-to-query minimum distances (plain formulation)
# ---------------------------------------------------------------------------
def phase1_z(emb, q_ids, q_w, *, bf16_matmul: bool = False,
             vocab_chunk: int | None = None) -> torch.Tensor:
    """Z[w, j] = distance from vocab word w to the closest word of query j.

    emb (v, m), q_ids (B, h) int, q_w (B, h) f32 (0 at padding) → (v, B) f32.
    ``vocab_chunk`` bounds the (chunk, B·h) intermediate.
    """
    t = emb[q_ids.reshape(-1).long()]   # (B*h, m)
    valid = (q_w > 0).reshape(-1)       # (B*h,)
    return phase1_z_from_t(emb, t, valid, q_ids.shape[0],
                           bf16_matmul=bf16_matmul, vocab_chunk=vocab_chunk)


def phase1_z_from_t(emb, t, valid, b: int, *, bf16_matmul: bool = False,
                    vocab_chunk: int | None = None) -> torch.Tensor:
    """phase1_z with the query-embedding gather hoisted out."""
    v = emb.shape[0]
    h = t.shape[0] // b

    def chunk_z(e_chunk):
        c = sq_dists(e_chunk, t, bf16_matmul=bf16_matmul)   # (cv, B*h)
        c = c.masked_fill(~valid[None, :], _INF)
        return safe_sqrt(c.reshape(-1, b, h).amin(dim=2))  # (cv, B)

    if vocab_chunk is None or vocab_chunk >= v:
        return chunk_z(emb)
    return torch.cat([chunk_z(emb[lo:lo + vocab_chunk])
                      for lo in range(0, v, vocab_chunk)], dim=0)


# ---------------------------------------------------------------------------
# Phase 2 — ELL SpMM against Z (plain formulation)
# ---------------------------------------------------------------------------
def phase2_spmm(resident: DocSet, z: torch.Tensor) -> torch.Tensor:
    """D1[i, j] = Σ_p weights[i,p] · Z[ids[i,p], j].  Returns (n, B) f32."""
    zg = z[resident.ids.long()]  # (n, h, B)
    return torch.einsum("nh,nhb->nb", resident.weights, zg)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def lc_rwmd_one_sided(resident: DocSet, queries: DocSet, emb, *,
                      bf16_matmul: bool = False) -> torch.Tensor:
    """Cost of moving each resident doc INTO each query doc: (n, B) f32.

    Phase 1 and phase 2 go through the kernel wrappers.
    """
    dev = resident.device
    z = ops.lc_rwmd_phase1(as_f32(emb, dev), queries.ids, queries.weights,
                           bf16_matmul=bf16_matmul)
    return ops.spmm_ell(resident.ids, resident.weights, z)


def lc_rwmd_streaming(resident: DocSet, queries: DocSet, emb, *,
                      vocab_chunk: int = 512, fuse: str = "jnp",
                      bf16_matmul: bool = False) -> torch.Tensor:
    """One-sided LC-RWMD with the fused phase-1→phase-2 streaming engine.

    The same value as :func:`lc_rwmd_one_sided`, but Z is never made at full
    (v, B): the vocabulary is scanned in ``vocab_chunk`` rows, each chunk's Z
    made and consumed into the running D at once.  ``fuse``: "jnp" (the
    plain chunk fold), "scan" (phase-1 kernel + blocked SpMM kernel per
    chunk) or "kernel" (the fused chunk kernel; Z lives only in shared
    memory).  Runs on the resident's device.
    """
    dev = resident.device
    queries = queries.to(dev)
    return ops.lc_rwmd_fused(
        as_f32(emb, dev), queries.ids, queries.weights, resident.ids,
        resident.weights, vocab_chunk=vocab_chunk, fuse=fuse,
        bf16_matmul=bf16_matmul)


def lc_rwmd_symmetric(set1: DocSet, set2: DocSet, emb, *,
                      bf16_matmul: bool = False) -> torch.Tensor:
    """Tight symmetric LC-RWMD: D = max(D1, D2ᵀ), shape (n1, n2) f32."""
    d1 = lc_rwmd_one_sided(set1, set2, emb, bf16_matmul=bf16_matmul)
    d2 = lc_rwmd_one_sided(set2, set1, emb, bf16_matmul=bf16_matmul)
    return torch.maximum(d1, d2.T)


def restrict_vocab(resident: DocSet, emb: torch.Tensor):
    """The paper's v_e optimization: drop vocab rows unused by the resident set.

    Returns (remapped resident DocSet, restricted emb (v_e, m), old→new map
    (v,) int32 with -1 at dropped rows).  Runs on the resident's device.
    """
    ids, w = resident.ids, resident.weights
    used = torch.unique(ids[w > 0].long())  # sorted ascending, as np.unique
    old_to_new = torch.full((emb.shape[0],), -1, dtype=torch.int32,
                            device=ids.device)
    old_to_new[used] = torch.arange(used.numel(), dtype=torch.int32,
                                    device=ids.device)
    new_ids = torch.where(w > 0, old_to_new[ids.long()],
                          torch.zeros_like(ids))
    sub = DocSet(ids=new_ids.contiguous(), weights=w)
    return sub, emb[used].contiguous(), old_to_new


def _phase1_from_t(emb_r: torch.Tensor, t_q: torch.Tensor, q_w: torch.Tensor,
                   *, bf16_matmul: bool,
                   vocab_chunk: int | None = None) -> torch.Tensor:
    """Z1 (v_e, B) over ``emb_r`` from pre-gathered (B*h, m) query targets.

    The phase-1 kernel on CUDA; on CPU its plain version, taken
    ``vocab_chunk`` vocab rows at a time where given (the bound of the
    (chunk, B·h) intermediate).
    """
    b, h = q_w.shape
    t, valid = t_q.reshape(b, h, -1), q_w > 0
    v = emb_r.shape[0]
    if emb_r.is_cuda or vocab_chunk is None or vocab_chunk >= v:
        return ops.lc_rwmd_phase1_pregathered(emb_r, t, valid,
                                              bf16_matmul=bf16_matmul)
    return torch.cat([
        ops.lc_rwmd_phase1_pregathered(emb_r[lo:lo + vocab_chunk], t, valid,
                                       bf16_matmul=bf16_matmul)
        for lo in range(0, v, vocab_chunk)])


def _topk_stream_from_z(seg: SegmentTensors, z1: torch.Tensor,
                        q_ids: torch.Tensor, t_q: torch.Tensor,
                        q_w: torch.Tensor, *, k: int, symmetric: bool,
                        row_block: int, bf16_matmul: bool,
                        row_valid: torch.Tensor | None = None,
                        q_gid: torch.Tensor | None = None) -> topk_lib.TopK:
    """The streaming top-k fold over the resident rows (after phase 1).

    One-sided: the fused phase-2 top-k (kernel on CUDA, slab fold on CPU).
    Symmetric, on CUDA: the swapped direction d21 (n, B) by the quadratic
    RWMD kernel's d21 mode (full table, full ids), then the fused phase-2
    top-k with d21 maxed into each D entry; no slab is built.  Symmetric,
    on CPU: ``row_block`` slabs; D1 of a slab through the ELL SpMM wrapper,
    the swapped direction from the slab's targets (gathered from the full
    table) by a plain GEMM (as the reference leaves it outside its
    kernels), both folded into a :class:`StreamingTopK` carry.  Exactly the
    top-k of the materialized matrix, ties included.  An empty resident doc
    is +inf in the swapped direction (a padded query word adds 0, not
    ``0 · inf``).

    ``row_valid`` (n,) bool: rows that are False (tombstones) are left out
    for every query; ``q_gid`` (B,): the pair (row ``q_gid[j]``, query j)
    is left out, rows counted from 0 here, so a caller with global ids
    subtracts its offset.  A left-out entry is never ranked: the unfilled
    tail is (3.4e38, -1) on CUDA and (+inf, -1) on CPU, after every real
    entry, +inf and NaN included.
    """
    b, h2 = q_w.shape
    n, h1 = seg.r_ids.shape
    kk = min(k, n)
    if not symmetric:
        d, i = ops.streaming_phase2_topk(seg.r_ids, seg.r_w, z1, kk,
                                         row_block=row_block, q_gid=q_gid,
                                         row_valid=row_valid)
        return topk_lib.TopK(d, i)
    if z1.is_cuda:
        d21 = ops.rwmd_d21(seg.emb, seg.ids, seg.r_w, q_ids, q_w,
                           bf16_matmul=bf16_matmul)
        d, i = ops.streaming_phase2_topk(seg.r_ids, seg.r_w, z1, kk,
                                         q_gid=q_gid, row_valid=row_valid,
                                         d21=d21)
        return topk_lib.TopK(d, i)

    r = max(1, min(row_block, n))
    stk = topk_lib.StreamingTopK(kk)
    carry = stk.init(b, device=z1.device)
    for lo in range(0, n, r):
        hi = min(lo + r, n)
        rr = hi - lo
        d1 = ops.spmm_ell(seg.r_ids[lo:hi], seg.r_w[lo:hi], z1)     # (R, B)
        t_r = seg.emb.index_select(0, seg.ids[lo:hi].reshape(-1))   # (R*h1, m)
        sq = sq_dists(t_q, t_r, bf16_matmul=bf16_matmul)
        # In place: the (B*h2, R*h1) slab is the fold's largest tensor.
        sq.masked_fill_(~(seg.r_w[lo:hi] > 0).reshape(1, -1), _INF)
        z2 = safe_sqrt(sq.reshape(b * h2, rr, h1).amin(dim=2))      # (B*h2, R)
        del sq
        d2 = _rw.d21_from_min(z2.reshape(b, h2, rr), q_w)           # (B, R)
        d_blk = torch.maximum(d1.T, d2)                             # (B, R)
        rows = torch.arange(lo, hi, dtype=torch.int32, device=z1.device)
        carry = stk.update(carry, *topk_lib.masked_entries(
            d_blk, rows, None if row_valid is None else row_valid[lo:hi],
            q_gid))
    return carry


def _segment_topk(seg: SegmentTensors, t_q: torch.Tensor, q_ids: torch.Tensor,
                  q_w: torch.Tensor, *, k: int, symmetric: bool,
                  row_block: int, bf16_matmul: bool,
                  vocab_chunk: int | None = None,
                  row_valid: torch.Tensor | None = None,
                  q_gid: torch.Tensor | None = None) -> topk_lib.TopK:
    """Phase 1 and the streaming top-k of one resident corpus (an engine's,
    or one segment's): TopK (B, min(k, n_rows)), local ids."""
    z1 = _phase1_from_t(seg.emb_r, t_q, q_w, bf16_matmul=bf16_matmul,
                        vocab_chunk=vocab_chunk)
    return _topk_stream_from_z(seg, z1, q_ids, t_q, q_w, k=k,
                               symmetric=symmetric, row_block=row_block,
                               bf16_matmul=bf16_matmul, row_valid=row_valid,
                               q_gid=q_gid)


def _segment_dense(seg: SegmentTensors, t_q: torch.Tensor, q_ids: torch.Tensor,
                   q_w: torch.Tensor, *, symmetric: bool, bf16_matmul: bool,
                   vocab_chunk: int | None = None,
                   row_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Materialized one-sided / symmetric distances of one resident corpus:
    (n_rows, B).

    Phase 1 and the ELL SpMM, and for the symmetric bound the swapped
    direction of the quadratic RWMD kernel's d21 mode (its plain version on
    CPU, ``_PLAIN_DOCS`` docs at a time).  Rows whose ``row_valid`` is
    False (tombstones) come out +inf.
    """
    z1 = _phase1_from_t(seg.emb_r, t_q, q_w, bf16_matmul=bf16_matmul,
                        vocab_chunk=vocab_chunk)
    d = ops.spmm_ell(seg.r_ids, seg.r_w, z1)
    if symmetric:
        d = torch.maximum(d, ops.rwmd_d21(seg.emb, seg.ids, seg.r_w, q_ids,
                                          q_w, bf16_matmul=bf16_matmul))
    return d if row_valid is None else d.masked_fill(~row_valid[:, None], _INF)


def _as_index(idx, device: torch.device) -> torch.Tensor:
    """``idx`` (numpy, list or tensor) as a flat int64 tensor on ``device``."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
    return idx.to(device).long().reshape(-1)


def _rows_spmm(res: DocSet, row_idx: torch.Tensor, z: torch.Tensor,
               owner: torch.Tensor | None) -> torch.Tensor:
    """(R, B) ELL SpMM of the rows ``row_idx`` of ``res`` (restricted ids)
    against ``z``; rows out of range, or False in ``owner``, weigh 0."""
    n = res.n_docs
    safe = row_idx.clamp(0, n - 1)
    ok = (row_idx >= 0) & (row_idx < n)
    if owner is not None:
        ok &= owner
    return ops.spmm_ell(res.ids[safe].contiguous(),
                        torch.where(ok[:, None], res.weights[safe], 0.0), z)


def _resident_tile(res: DocSet, idx, live: torch.Tensor | None):
    """The resident docs ``idx`` (B,) as a query DocSet, and a (B,) bool
    mask of the ids that name a doc: out-of-range ids, and ids that
    ``live`` marks dead, are empty histograms (zero weights)."""
    n = res.n_docs
    idx = _as_index(idx, res.device)
    safe = idx.clamp(0, n - 1)
    ok = (idx >= 0) & (idx < n)
    if live is not None:
        ok &= live[safe]
    return DocSet(ids=res.ids[safe],
                  weights=torch.where(ok[:, None], res.weights[safe],
                                      0.0)), ok


class LCRWMDEngine:
    """Serve-time LC-RWMD against a fixed resident corpus.

    Built ONCE from a resident :class:`DocSet` + embedding table on
    ``device`` (``None`` → ``"cuda"``; without a card that raises unless
    ``device="cpu"``), the engine hoists everything that does not depend on
    the query batch out of the serve path:

      * the paper's ``v_e`` vocabulary restriction (phase 1 / phase 2 only
        touch resident-used vocab rows; queries still gather from the FULL
        table, so out-of-resident-vocab query words stay exact);
      * float32 casts.

    No (n·h1, m) gather of the resident docs' word embeddings is held: the
    card's routes read the full table by the resident ids, and the rerank
    and the centroids gather the rows they need.

    On CUDA, phase 1, the ELL SpMM, the fused phase-2 top-k, the
    symmetric bound's swapped direction and the Sinkhorn rerank launch the
    port's kernels; on CPU their plain versions run.  Top-k results are in
    ``(distance, doc id)`` order, ties included.
    """

    def __init__(self, resident: DocSet, emb, *, device=None,
                 bf16_matmul: bool = False, row_block: int = 128):
        dev = resolve_device(device)
        self.device = dev
        self.resident = resident.to(dev)
        self.emb_full = as_f32(emb, dev).contiguous()
        self.bf16_matmul = bf16_matmul
        self.row_block = max(1, min(row_block, self.resident.n_docs))

        sub, emb_r, old_to_new = restrict_vocab(self.resident, self.emb_full)
        self.resident_restricted = sub
        self.emb_restricted = emb_r
        self.old_to_new = old_to_new

    # -- internals --------------------------------------------------------
    def _queries(self, queries: DocSet) -> DocSet:
        return queries.to(self.device)

    def gather_queries(self, q_ids: torch.Tensor) -> torch.Tensor:
        """(B, h, m) query word embeddings from the FULL table."""
        b, h = q_ids.shape
        return self._gather_flat(q_ids).reshape(b, h, -1)

    def _gather_flat(self, q_ids: torch.Tensor) -> torch.Tensor:
        """(B*h, m) query gather from the full table."""
        return self.emb_full.index_select(
            0, q_ids.to(self.device).reshape(-1))

    def _segment_tensors(self) -> SegmentTensors:
        return SegmentTensors(
            emb_r=self.emb_restricted, r_ids=self.resident_restricted.ids,
            r_w=self.resident_restricted.weights, emb=self.emb_full,
            ids=self.resident.ids)

    def _phase1(self, t_q: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
        """Z1 (v_e, B) over the restricted vocab from (B*h, m) targets."""
        return _phase1_from_t(self.emb_restricted, t_q, q_w,
                              bf16_matmul=self.bf16_matmul)

    def _dense(self, queries: DocSet, *, symmetric: bool) -> torch.Tensor:
        queries = self._queries(queries)
        return _segment_dense(
            self._segment_tensors(), self._gather_flat(queries.ids),
            queries.ids, queries.weights, symmetric=symmetric,
            bf16_matmul=self.bf16_matmul)

    def _topk_dispatch(self, queries: DocSet, k: int, symmetric: bool):
        queries = self._queries(queries)
        return _segment_topk(
            self._segment_tensors(), self._gather_flat(queries.ids),
            queries.ids, queries.weights, k=k, symmetric=symmetric,
            row_block=self.row_block, bf16_matmul=self.bf16_matmul)

    # -- public entry points ----------------------------------------------
    def one_sided(self, queries: DocSet) -> torch.Tensor:
        """D1 (n, B): cost of moving each resident doc into each query."""
        return self._dense(queries, symmetric=False)

    def symmetric(self, queries: DocSet) -> torch.Tensor:
        """Tight symmetric bound max(D1, D2ᵀ), shape (n, B)."""
        return self._dense(queries, symmetric=True)

    def topk(self, queries: DocSet, k: int) -> topk_lib.TopK:
        """Per-query top-k smallest symmetric LC-RWMD: TopK (B, k)."""
        return self._topk_dispatch(queries, k, symmetric=True)

    def topk_streaming(self, queries: DocSet, k: int) -> topk_lib.TopK:
        """Per-query top-k smallest ONE-SIDED LC-RWMD (D1), streamed.

        On CUDA: phase 1 kernel → fused phase-2 top-k kernel; the (n, B)
        matrix is never written.  Returns a TopK of (B, min(k, n)).
        """
        return self._topk_dispatch(queries, k, symmetric=False)

    def symmetric_topk_streaming(self, queries: DocSet, k: int) -> topk_lib.TopK:
        """Per-query top-k smallest SYMMETRIC bound max(D1, D2ᵀ), streamed.

        On CUDA: phase 1, the swapped direction D2ᵀ (n, B) by the quadratic
        RWMD kernel's d21 mode, then the fused phase-2 top-k with it maxed
        in; no slab.  On CPU: ``row_block`` slabs (peak O(B·h2 ·
        row_block·h1))."""
        return self._topk_dispatch(queries, k, symmetric=True)

    def rerank_topk(self, queries: DocSet, cand_indices: torch.Tensor, k: int,
                    *, sinkhorn_kw: dict | None = None) -> topk_lib.TopK:
        """Batched Sinkhorn-WMD re-rank of per-query candidate doc ids.

        ``cand_indices`` (B, budget) resident doc ids; returns a TopK of
        (B, min(k, budget)): ascending WMD + global doc ids.  The
        candidates' word embeddings are gathered from the full table.
        """
        from repro_torch.core.wmd import wmd_candidate_values

        queries = self._queries(queries)
        cand_indices = cand_indices.to(self.device)
        t1, w1, t2 = self.candidate_pairs(cand_indices.reshape(-1).long(),
                                          queries.ids)
        vals = wmd_candidate_values(
            t1, w1, t2, queries.weights, use_kernel=True,
            bf16_matmul=self.bf16_matmul, **(sinkhorn_kw or {}))
        return topk_lib.topk_from_candidates(vals, cand_indices, k)

    # -- corpus-analytics (query-tile) entry points ------------------------
    def resident_tile(self, idx) -> DocSet:
        """The resident docs named by ``idx`` (B,) as a query DocSet;
        out-of-range entries (tile padding, e.g. -1) are empty histograms."""
        return _resident_tile(self.resident, idx, None)[0]

    def symmetric_resident(self, idx) -> torch.Tensor:
        """Symmetric bound (n, B) whose queries are resident docs ``idx``
        (B,): phase 1, the ELL SpMM and the swapped direction's d21 mode on
        the card.  Out-of-range entries give +inf columns."""
        tile, ok = _resident_tile(self.resident, idx, None)
        return self.symmetric(tile).masked_fill(~ok[None, :], _INF)

    def phase1_resident(self, idx) -> torch.Tensor:
        """Phase-1 Z (v_e, B) whose queries are resident docs ``idx`` (B,):
        the tile primitive of the all-pairs scheduler (made once per corpus
        tile, then read by many :meth:`one_sided_rows` calls).  The tile's
        word embeddings are gathered by id from the full table; the
        phase-1 kernel on the card.  Out-of-range ids are empty
        histograms."""
        tile, _ = _resident_tile(self.resident, idx, None)
        return self._phase1(self._gather_flat(tile.ids), tile.weights)

    def _one_sided_rows_impl(self, row_idx: torch.Tensor,
                             z: torch.Tensor) -> torch.Tensor:
        return _rows_spmm(self.resident_restricted, row_idx, z, None)

    def one_sided_rows(self, row_idx, z: torch.Tensor) -> torch.Tensor:
        """Phase 2 restricted to resident rows ``row_idx`` (R,): the ELL SpMM
        of their restricted ids and weights against a :meth:`phase1_resident`
        tile ``z`` (v_e, B), i.e. D1[row_idx, tile] as (R, B), O(R·h) a
        query column.  Out-of-range rows are empty histograms (0)."""
        return self._one_sided_rows_impl(_as_index(row_idx, self.device), z)

    def candidate_pairs(self, flat: torch.Tensor, q_ids: torch.Tensor):
        """The rerank's inputs from the engine's device tensors: the word
        embeddings (P, h1, m) and weights (P, h1) of resident docs ``flat``
        (P,) long, and the embeddings (B, h2, m) of query word ids ``q_ids``
        (B, h2).  Nothing is copied to the device."""
        t1, w1 = doc_targets(self.resident, self.emb_full, flat)
        return t1, w1, self.gather_queries(q_ids)


# ---------------------------------------------------------------------------
# Segmented corpora — incremental ingest / delete without a full rebuild
# ---------------------------------------------------------------------------
def _offset_topk(tk: topk_lib.TopK, offset: int) -> topk_lib.TopK:
    """Local segment ids made global; an unfilled slot's -1 stays -1."""
    return topk_lib.TopK(
        tk.dists, torch.where(tk.indices >= 0, tk.indices + offset,
                              tk.indices))


class EngineSegment:
    """One immutable unit of a :class:`SegmentedEngine`.

    Owns a contiguous global doc-id range ``[offset, offset + n_rows)`` and
    the state an :class:`LCRWMDEngine` would build for it: the per-segment
    ``v_e`` vocab restriction, the remapped ELL resident matrix, and the
    segment's ids into the full table.  The reference pads rows and the
    restricted vocabulary so that repeated shapes reuse a compiled trace;
    eager PyTorch compiles no trace and the kernels take any shape, so a
    segment holds its docs unpadded.
    """

    def __init__(self, docs: DocSet, emb_full: torch.Tensor, *, offset: int):
        self.docs = docs
        self.offset = int(offset)
        sub, emb_r, old_to_new = restrict_vocab(docs, emb_full)
        self.old_to_new = old_to_new
        self.tensors = SegmentTensors(emb_r=emb_r, r_ids=sub.ids,
                                      r_w=sub.weights, emb=emb_full,
                                      ids=docs.ids)

    @property
    def n_rows(self) -> int:
        return self.docs.n_docs

    @property
    def nbytes(self) -> int:
        """Device bytes of the tensors this segment owns (not the shared
        full table): the restricted rows, both ELL id sets, the weights and
        the vocab map."""
        t = self.tensors
        return sum(x.numel() * x.element_size()
                   for x in (t.emb_r, t.r_ids, t.r_w, t.ids, self.old_to_new))


class SegmentedEngine:
    """LC-RWMD engine over a base + delta segment list: churn without rebuild.

    The query surface of :class:`LCRWMDEngine` (``one_sided`` /
    ``symmetric`` / streaming ``topk*`` / ``rerank_topk``, and the
    resident-query tiles ``resident_tile`` / ``symmetric_resident`` that
    the clustering runs on) plus a corpus lifecycle:

      * :meth:`append` builds ONE small :class:`EngineSegment` over the new
        docs (its own v_e restriction), cost O(delta), not O(corpus);
        returns the assigned global doc ids.
      * :meth:`delete` flips per-row tombstone bits on the host; the device
        masks are copied once per corpus version, at the next call that
        reads them.  Dead docs are +inf in every distance path and never
        appear in a top-k.
      * :meth:`compact` merges all segments into one base segment, re-running
        the vocab restriction with tombstoned rows zero-weighted.  Global
        doc ids are STABLE: dead rows keep their slots as empty histograms.

    Built on ``device`` (``None`` → ``"cuda"``; without a card that raises
    unless ``device="cpu"``).  On CUDA every segment runs phase 1, the
    fused top-k (with its tombstone mask), the swapped direction's d21 mode
    for the symmetric bound, the ELL SpMM for the dense methods and the
    Sinkhorn rerank on the port's kernels; on CPU their plain versions run.
    Per-segment (distance, global id) candidates merge in the shared
    lexicographic order, so results equal a monolithic rebuild over the
    merged live corpus.  No segment holds an (n·h1, m) gather of its
    targets.
    """

    def __init__(self, resident: DocSet | None, emb, *, device=None,
                 bf16_matmul: bool = False, vocab_chunk: int | None = None,
                 row_block: int = 128):
        dev = resolve_device(device)
        self.device = dev
        self.emb_full = as_f32(emb, dev).contiguous()
        self.bf16_matmul = bf16_matmul
        self.vocab_chunk = vocab_chunk
        self.row_block = max(1, int(row_block))
        self.segments: list[EngineSegment] = []
        self._live: list[np.ndarray] = []
        self.version = 0          # bumped on every append/delete/compact
        self._cache: dict = {}    # device views of the current version
        if resident is not None and resident.n_docs:
            self._append_segment(resident.to(dev))

    # -- lifecycle --------------------------------------------------------
    def _append_segment(self, docs: DocSet) -> None:
        self.segments.append(EngineSegment(docs, self.emb_full,
                                           offset=self.n_docs))
        self._live.append(np.ones(docs.n_docs, dtype=bool))
        self._bump()

    def _bump(self) -> None:
        self.version += 1
        self._cache = {}

    def append(self, docs: DocSet) -> np.ndarray:
        """Ingest ``docs`` as a new delta segment; returns their global ids."""
        if docs.n_docs == 0:
            return np.empty(0, dtype=np.int64)
        docs = docs.to(self.device)
        if self.segments:
            h = self.h_max
            if docs.h_max > h:
                raise ValueError(
                    f"appended docs have h_max={docs.h_max} > engine "
                    f"h_max={h}; re-pad the corpus or rebuild")
            if docs.h_max < h:
                pad = (0, h - docs.h_max)
                docs = DocSet(ids=torch.nn.functional.pad(docs.ids, pad),
                              weights=torch.nn.functional.pad(docs.weights,
                                                              pad))
        lo = self.n_docs
        self._append_segment(docs)
        return np.arange(lo, lo + docs.n_docs, dtype=np.int64)

    def delete(self, doc_ids) -> int:
        """Tombstone global doc ids; returns how many were newly deleted."""
        n = self.n_docs
        g = np.atleast_1d(np.asarray(doc_ids, dtype=np.int64))
        bad = (g < 0) | (g >= n)
        if bad.any():
            raise IndexError(f"doc id {int(g[bad][0])} out of range [0, {n})")
        removed = 0
        for seg, live in zip(self.segments, self._live):
            own = (g >= seg.offset) & (g < seg.offset + seg.n_rows)
            local = np.unique(g[own] - seg.offset)
            removed += int(live[local].sum())
            live[local] = False
        if removed:
            self._bump()
        return removed

    def compact(self) -> None:
        """Merge every segment into one base segment (stable global ids).

        Re-runs the v_e vocab restriction over the merged corpus with
        tombstoned rows zero-weighted, so deleted docs' words leave the
        restricted vocabulary; dead rows keep their (now empty) id slots.
        """
        if not self.segments:
            return
        if len(self.segments) == 1 and bool(self._live[0].all()):
            return   # already one fully-live base segment
        res = self.resident
        live = self.live_mask()
        merged = DocSet(
            ids=res.ids.clone(),
            weights=torch.where(self.live_mask_device()[:, None],
                                res.weights, 0.0))
        self.segments = [EngineSegment(merged, self.emb_full, offset=0)]
        self._live = [live]
        self._bump()

    # -- corpus views ------------------------------------------------------
    @property
    def n_docs(self) -> int:
        """Size of the global doc-id space (INCLUDING tombstoned docs)."""
        return sum(s.n_rows for s in self.segments)

    @property
    def n_live(self) -> int:
        """Docs that are actually queryable (excludes tombstones)."""
        return int(sum(live.sum() for live in self._live))

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def h_max(self) -> int:
        return self.segments[0].docs.h_max if self.segments else 0

    @property
    def nbytes(self) -> int:
        """Device bytes owned by the segments (not the shared full table)."""
        return sum(seg.nbytes for seg in self.segments)

    def _cached(self, key: str, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    @property
    def resident(self) -> DocSet:
        """The merged corpus as one device DocSet, global doc id == row
        (cached per version).  Tombstoned docs keep their rows and weights;
        :meth:`live_mask` says which are dead."""
        def make():
            if len(self.segments) == 1:
                return self.segments[0].docs
            return DocSet(
                ids=torch.cat([s.docs.ids for s in self.segments]),
                weights=torch.cat([s.docs.weights for s in self.segments]))
        return self._cached("resident", make)

    def live_mask(self) -> np.ndarray:
        """(n_docs,) host bool mask: True where the doc is not tombstoned."""
        if not self.segments:
            return np.zeros(0, dtype=bool)
        return np.concatenate(self._live)

    def live_mask_device(self) -> torch.Tensor:
        """(n_docs,) device live mask (one copy per corpus version)."""
        return self._cached("live", lambda: torch.from_numpy(
            self.live_mask()).to(self.device))

    def segment_live_device(self) -> tuple[torch.Tensor, ...]:
        """Per-segment (n_rows,) device live masks (one copy per corpus
        version)."""
        return self._cached("seg_live", lambda: tuple(
            torch.from_numpy(l).to(self.device) for l in self._live))

    # -- query surface -----------------------------------------------------
    def _gather_flat(self, q_ids: torch.Tensor) -> torch.Tensor:
        """(B*h, m) query gather from the full table."""
        return self.emb_full.index_select(
            0, q_ids.to(self.device).reshape(-1))

    def gather_queries(self, q_ids: torch.Tensor) -> torch.Tensor:
        """(B, h, m) query word embeddings from the FULL table."""
        b, h = q_ids.shape
        return self._gather_flat(q_ids).reshape(b, h, -1)

    def candidate_pairs(self, flat: torch.Tensor, q_ids: torch.Tensor):
        """The rerank's inputs from the engine's device tensors (as
        :meth:`LCRWMDEngine.candidate_pairs`): the word embeddings
        (P, h1, m) and weights (P, h1) of global doc ids ``flat`` (P,), and
        the embeddings (B, h2, m) of query word ids ``q_ids``."""
        t1, w1 = doc_targets(self.resident, self.emb_full, flat)
        return t1, w1, self.gather_queries(q_ids)

    def fold_topk(self, queries: DocSet, k: int, *, symmetric: bool,
                  q_gid: torch.Tensor | None = None,
                  bf16_matmul: bool | None = None) -> topk_lib.TopK:
        """Per-segment streaming top-k, merged: TopK (B, min(k, n_docs)).

        ``q_gid`` (B,) device int32 global ids to self-exclude (each
        segment sees them shifted by its offset); ``bf16_matmul`` overrides
        the engine's for phase 1 and the swapped direction (the serve
        step's own flag).
        """
        queries = queries.to(self.device)
        bf16 = self.bf16_matmul if bf16_matmul is None else bf16_matmul
        t_q = self._gather_flat(queries.ids)
        parts = []
        for seg, live in zip(self.segments, self.segment_live_device()):
            tk = _segment_topk(
                seg.tensors, t_q, queries.ids, queries.weights,
                row_valid=live, k=min(k, seg.n_rows), symmetric=symmetric,
                row_block=max(1, min(self.row_block, seg.n_rows)),
                bf16_matmul=bf16, vocab_chunk=self.vocab_chunk,
                q_gid=None if q_gid is None else q_gid - seg.offset)
            parts.append(_offset_topk(tk, seg.offset))
        kk = min(k, self.n_docs)
        if len(parts) == 1 and parts[0].dists.shape[-1] == kk:
            return parts[0]
        return topk_lib.merge_topk(parts, kk)

    def topk(self, queries: DocSet, k: int) -> topk_lib.TopK:
        """Top-k smallest symmetric LC-RWMD over all live docs: TopK (B, k)."""
        return self.fold_topk(queries, k, symmetric=True)

    def topk_streaming(self, queries: DocSet, k: int) -> topk_lib.TopK:
        """Top-k smallest one-sided LC-RWMD (D1), segment-folded."""
        return self.fold_topk(queries, k, symmetric=False)

    def symmetric_topk_streaming(self, queries: DocSet,
                                 k: int) -> topk_lib.TopK:
        """Top-k smallest symmetric bound, segment-folded."""
        return self.fold_topk(queries, k, symmetric=True)

    def _dense(self, queries: DocSet, *, symmetric: bool) -> torch.Tensor:
        queries = queries.to(self.device)
        t_q = self._gather_flat(queries.ids)
        return torch.cat([
            _segment_dense(seg.tensors, t_q, queries.ids, queries.weights,
                           row_valid=live, symmetric=symmetric,
                           bf16_matmul=self.bf16_matmul,
                           vocab_chunk=self.vocab_chunk)
            for seg, live in zip(self.segments, self.segment_live_device())])

    def one_sided(self, queries: DocSet) -> torch.Tensor:
        """D1 (n_docs, B); tombstoned rows are +inf."""
        return self._dense(queries, symmetric=False)

    def symmetric(self, queries: DocSet) -> torch.Tensor:
        """max(D1, D2ᵀ) (n_docs, B); tombstoned rows are +inf."""
        return self._dense(queries, symmetric=True)

    # -- corpus-analytics (query-tile) entry points ------------------------
    def resident_tile(self, idx) -> DocSet:
        """Resident docs named by global ids ``idx`` (B,) as a query DocSet.

        Out-of-range AND tombstoned entries behave as empty histograms.
        """
        return _resident_tile(self.resident, idx, self.live_mask_device())[0]

    def symmetric_resident(self, idx) -> torch.Tensor:
        """Symmetric bound (n_docs, B) whose queries are resident docs
        ``idx`` (B,): each segment's phase 1, ELL SpMM and d21 mode on the
        card.  Tombstoned rows are +inf; out-of-range and tombstoned
        queries give +inf columns."""
        tile, ok = _resident_tile(self.resident, idx, self.live_mask_device())
        return self.symmetric(tile).masked_fill(~ok[None, :], _INF)

    def phase1_resident(self, idx) -> tuple[torch.Tensor, ...]:
        """Per-segment phase-1 Z tiles (v_e_s, B) whose queries are resident
        docs ``idx`` (B,), one per segment: the ``z`` that
        :meth:`one_sided_rows` takes.  Out-of-range and tombstoned ids are
        empty histograms."""
        tile = self.resident_tile(idx)
        t_q = self._gather_flat(tile.ids)
        return tuple(_phase1_from_t(seg.tensors.emb_r, t_q, tile.weights,
                                    bf16_matmul=self.bf16_matmul,
                                    vocab_chunk=self.vocab_chunk)
                     for seg in self.segments)

    def _one_sided_rows_impl(self, row_idx: torch.Tensor, z) -> torch.Tensor:
        zs = z if isinstance(z, (tuple, list)) else (z,)
        total = None
        for seg, zz in zip(self.segments, zs):
            local = row_idx - seg.offset
            owner = (local >= 0) & (local < seg.n_rows)
            d = _rows_spmm(DocSet(ids=seg.tensors.r_ids,
                                  weights=seg.tensors.r_w), local, zz, owner)
            d = d.masked_fill(~owner[:, None], 0.0)
            total = d if total is None else total + d
        return total

    def one_sided_rows(self, row_idx, z) -> torch.Tensor:
        """Phase 2 restricted to global rows ``row_idx`` (R,): (R, B).

        ``z`` is a :meth:`phase1_resident` tuple; each row takes its value
        from the one segment that owns it (the others add 0).  Tombstoned
        rows still produce values here: schedulers mask them by
        :meth:`live_mask_device`.
        """
        return self._one_sided_rows_impl(_as_index(row_idx, self.device), z)

    def rerank_topk(self, queries: DocSet, cand_indices: torch.Tensor, k: int,
                    *, sinkhorn_kw: dict | None = None) -> topk_lib.TopK:
        """Batched Sinkhorn-WMD re-rank of global candidate doc ids.

        ``cand_indices`` (B, budget); returns a TopK of (B, min(k, budget)).
        Empty (-1) and tombstoned candidates get +inf WMD.  Candidate
        embeddings are gathered from the full table by the merged
        corpus's ids; the solve is the Sinkhorn-WMD kernel on CUDA (the
        reference runs its batched jnp solver here), its plain version on
        CPU.
        """
        from repro_torch.core.wmd import wmd_candidate_values

        queries = queries.to(self.device)
        n = self.n_docs
        cand = cand_indices.to(self.device)
        t1, w1, t2 = self.candidate_pairs(cand.reshape(-1).clamp(0, n - 1),
                                          queries.ids)
        valid = (cand >= 0) & self.live_mask_device()[
            cand.clamp(0, n - 1).long()]
        vals = wmd_candidate_values(
            t1, w1, t2, queries.weights,
            use_kernel=True, bf16_matmul=self.bf16_matmul,
            **(sinkhorn_kw or {}))
        vals = vals.masked_fill(~valid, _INF)
        return topk_lib.topk_from_candidates(vals, cand, k)
