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

_INF = float("inf")


def as_f32(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``x`` (numpy or tensor) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


class SegmentTensors(NamedTuple):
    """Device tensors of one resident corpus, as the streaming fold reads them."""

    emb_r: torch.Tensor     # (v_e, m) restricted embedding rows (phase-1 input)
    r_ids: torch.Tensor     # (n, h1) restricted int32 word ids (ELL)
    r_w: torch.Tensor       # (n, h1) f32 weights (0 at padding slots)
    t_r: torch.Tensor       # (n*h1, m) pre-gathered FULL-table word embeddings
    valid_r: torch.Tensor   # (n*h1,) bool slot validity


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


def _topk_stream_from_z(seg: SegmentTensors, z1: torch.Tensor,
                        t_q: torch.Tensor, q_w: torch.Tensor, *, k: int,
                        symmetric: bool, row_block: int,
                        bf16_matmul: bool) -> topk_lib.TopK:
    """The streaming top-k fold over the resident rows (after phase 1).

    One-sided: the fused phase-2 top-k (kernel on CUDA, slab fold on CPU).
    Symmetric: ``row_block`` slabs; D1 of a slab through the ELL SpMM
    wrapper, the swapped direction from the pre-gathered resident targets
    by a plain GEMM (as the reference leaves it outside its kernels), both
    folded into a :class:`StreamingTopK` carry.  Exactly the top-k of the
    materialized matrix, ties included.
    """
    b, h2 = q_w.shape
    n, h1 = seg.r_ids.shape
    kk = min(k, n)
    if not symmetric:
        d, i = ops.streaming_phase2_topk(seg.r_ids, seg.r_w, z1, kk,
                                         row_block=row_block)
        return topk_lib.TopK(d, i)

    r = max(1, min(row_block, n))
    stk = topk_lib.StreamingTopK(kk)
    carry = stk.init(b, device=z1.device)
    for lo in range(0, n, r):
        hi = min(lo + r, n)
        rr = hi - lo
        d1 = ops.spmm_ell(seg.r_ids[lo:hi], seg.r_w[lo:hi], z1)     # (R, B)
        sq = sq_dists(t_q, seg.t_r[lo * h1:hi * h1], bf16_matmul=bf16_matmul)
        # In place: the (B*h2, R*h1) slab is the fold's largest tensor.
        sq.masked_fill_(~seg.valid_r[lo * h1:hi * h1][None, :], _INF)
        z2 = safe_sqrt(sq.reshape(b * h2, rr, h1).amin(dim=2))      # (B*h2, R)
        del sq
        d2 = torch.einsum("bh,bhr->br", q_w, z2.reshape(b, h2, rr))
        d_blk = torch.maximum(d1.T, d2)                             # (B, R)
        rows = torch.arange(lo, hi, dtype=torch.int32, device=z1.device)
        carry = stk.update(carry, d_blk, rows[None, :].expand(b, rr))
    return carry


class LCRWMDEngine:
    """Serve-time LC-RWMD against a fixed resident corpus.

    Built ONCE from a resident :class:`DocSet` + embedding table on
    ``device`` (``None`` → ``"cuda"``; without a card that raises unless
    ``device="cpu"``), the engine hoists everything that does not depend on
    the query batch out of the serve path:

      * the paper's ``v_e`` vocabulary restriction (phase 1 / phase 2 only
        touch resident-used vocab rows; queries still gather from the FULL
        table, so out-of-resident-vocab query words stay exact);
      * the resident-side word-embedding gather ``emb[resident.ids]``
        (``_t_r``, (n·h1, m) f32, built once by one ``index_select`` with no
        second copy: at 700,000 docs × 48 words × 300 dims it is 40.3 GB);
      * float32 casts.

    On CUDA, phase 1, the ELL SpMM, the fused phase-2 top-k and the
    Sinkhorn rerank launch the port's kernels; on CPU their plain versions
    run.  Top-k results are in ``(distance, doc id)`` order, ties included.
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

        # Pre-gathered side-2 targets: the resident docs' word embeddings.
        self._t_r = self.emb_full.index_select(
            0, self.resident.ids.reshape(-1))                 # (n*h1, m)
        self._valid_r = (self.resident.weights > 0).reshape(-1)  # (n*h1,)

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
            r_w=self.resident_restricted.weights, t_r=self._t_r,
            valid_r=self._valid_r)

    def _phase1(self, t_q: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
        """Z1 (v_e, B) over the restricted vocab from (B*h, m) targets."""
        b, h = q_w.shape
        return ops.lc_rwmd_phase1_pregathered(
            self.emb_restricted, t_q.reshape(b, h, -1), q_w > 0,
            bf16_matmul=self.bf16_matmul)

    def _d1_from_t(self, t_q: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
        """Resident→query direction (n, B) from pre-gathered targets."""
        z1 = self._phase1(t_q, q_w)
        return ops.spmm_ell(self.resident_restricted.ids,
                            self.resident_restricted.weights, z1)

    def _symmetric_from_t(self, t_q: torch.Tensor,
                          q_w: torch.Tensor) -> torch.Tensor:
        """Symmetric bound from pre-gathered (B*h2, m) query targets.

        Builds the dense (B·h2, n·h1) swapped-direction matrix: small
        corpora only (the streaming methods never build it).
        """
        b, h2 = q_w.shape
        n, h1 = self.resident.ids.shape
        d1 = self._d1_from_t(t_q, q_w)                       # (n, B)
        sq = sq_dists(t_q, self._t_r, bf16_matmul=self.bf16_matmul)
        sq.masked_fill_(~self._valid_r[None, :], _INF)
        z2 = safe_sqrt(sq.reshape(b * h2, n, h1).amin(dim=2))
        d2 = torch.einsum("bh,bhn->bn", q_w, z2.reshape(b, h2, n))
        return torch.maximum(d1, d2.T)

    def _topk_dispatch(self, queries: DocSet, k: int, symmetric: bool):
        queries = self._queries(queries)
        t_q = self._gather_flat(queries.ids)
        z1 = self._phase1(t_q, queries.weights)
        return _topk_stream_from_z(
            self._segment_tensors(), z1, t_q, queries.weights, k=k,
            symmetric=symmetric, row_block=self.row_block,
            bf16_matmul=self.bf16_matmul)

    # -- public entry points ----------------------------------------------
    def one_sided(self, queries: DocSet) -> torch.Tensor:
        """D1 (n, B): cost of moving each resident doc into each query."""
        queries = self._queries(queries)
        return self._d1_from_t(self._gather_flat(queries.ids), queries.weights)

    def symmetric(self, queries: DocSet) -> torch.Tensor:
        """Tight symmetric bound max(D1, D2ᵀ), shape (n, B); dense, small n."""
        queries = self._queries(queries)
        return self._symmetric_from_t(self._gather_flat(queries.ids),
                                      queries.weights)

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
        """Per-query top-k smallest SYMMETRIC bound max(D1, D2ᵀ), streamed in
        ``row_block`` slabs (peak O(B·h2 · row_block·h1))."""
        return self._topk_dispatch(queries, k, symmetric=True)

    def rerank_topk(self, queries: DocSet, cand_indices: torch.Tensor, k: int,
                    *, sinkhorn_kw: dict | None = None) -> topk_lib.TopK:
        """Batched Sinkhorn-WMD re-rank of per-query candidate doc ids.

        ``cand_indices`` (B, budget) resident doc ids; returns a TopK of
        (B, min(k, budget)): ascending WMD + global doc ids.  The
        candidates' word embeddings come from the pre-gathered ``_t_r``.
        """
        from repro_torch.core.wmd import wmd_candidate_values

        queries = self._queries(queries)
        cand_indices = cand_indices.to(self.device)
        n, h1 = self.resident.ids.shape
        flat = cand_indices.reshape(-1).long()
        vals = wmd_candidate_values(
            self._t_r.reshape(n, h1, -1).index_select(0, flat),
            self.resident.weights.index_select(0, flat),
            self.gather_queries(queries.ids), queries.weights,
            bf16_matmul=self.bf16_matmul, **(sinkhorn_kw or {}))
        return topk_lib.topk_from_candidates(vals, cand_indices, k)
