"""Quadratic-complexity Relaxed Word Mover's Distance (paper Sec. III).

The baseline the paper accelerates: per document pair, gather both
embedding matrices, form the full ``h1 x h2`` distance matrix ``C``, take
row-wise minima and dot with the term weights; symmetrize with the
column-wise pass over the same ``C``.  Plain PyTorch, as in the reference
(its quadratic RWMD runs outside any Pallas kernel); the fused kernel is
``repro_torch.kernels.ops.rwmd_pairwise``.

Padding protocol, as in the reference: padded slots have weight 0 and their
rows/columns are masked to +inf before the minima.  So a resident doc with
no word gives ``inf · 0 = NaN`` in the column pass, and a query with no
word gives ``inf``; the fused kernel counts those minima as 3.4e38 instead.
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import dists, pair_dists
from repro_torch.data.docs import DocSet

_INF = float("inf")


def _rwmd_from_c(c: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """max(d12, d21) from distance blocks c (..., h1, h2), w1 (..., h1),
    w2 (..., h2) → (...)."""
    m1 = w1 > 0
    m2 = w2 > 0
    row_min = torch.where(m2[..., None, :], c, _INF).amin(dim=-1)
    d12 = (w1 * torch.where(m1, row_min, 0.0)).sum(dim=-1)
    col_min = torch.where(m1[..., :, None], c, _INF).amin(dim=-2)
    d21 = (col_min * torch.where(m2, w2, 0.0)).sum(dim=-1)
    return torch.maximum(d12, d21)


def rwmd_pair(ids1, w1, ids2, w2, emb, *,
              bf16_matmul: bool = False) -> torch.Tensor:
    """Symmetric RWMD between two padded histograms. Returns a scalar f32.

    ``ids*``: (h,) int; ``w*``: (h,) f32 (L1, 0 at padding); ``emb``: (v, m).
    """
    c = dists(emb[ids1.long()], emb[ids2.long()], bf16_matmul=bf16_matmul)
    return _rwmd_from_c(c, w1, w2)


def rwmd_pairs_from_t(t1, w1, t2, w2, *,
                      bf16_matmul: bool = False) -> torch.Tensor:
    """Symmetric RWMD for P independent histogram pairs from PRE-GATHERED
    embeddings: t1 (P, h1, m), w1 (P, h1), t2 (P, h2, m), w2 (P, h2) → (P,).
    """
    return _rwmd_from_c(pair_dists(t1, t2, bf16_matmul=bf16_matmul), w1, w2)


def _block(resident: DocSet, t1: torch.Tensor, q_ids: torch.Tensor,
           q_w: torch.Tensor, emb: torch.Tensor,
           bf16_matmul: bool) -> torch.Tensor:
    """(n, Q) RWMD of a block of Q queries against every resident doc, from
    one GEMM-shaped distance computation (n·h1, Q·h2)."""
    n, h1 = resident.ids.shape
    q, h2 = q_ids.shape
    t2 = emb[q_ids.reshape(-1).long()]                        # (Q*h2, m)
    c = dists(t1, t2, bf16_matmul=bf16_matmul)                # (n*h1, Q*h2)
    c = c.reshape(n, h1, q, h2).permute(0, 2, 1, 3)           # (n, Q, h1, h2)
    return _rwmd_from_c(c, resident.weights[:, None, :], q_w[None, :, :])


def rwmd_one_vs_many(resident: DocSet, q_ids, q_w, emb, *,
                     bf16_matmul: bool = False) -> torch.Tensor:
    """Symmetric RWMD of ONE query histogram against every resident doc.

    The paper's GPU mapping (Fig. 8): all resident embedding matrices as one
    (n·h1, m) matrix, one GEMM-shaped distance computation against the
    query's (h2, m) matrix, then row/col minima and weighted sums per doc.
    Returns (n,) f32.
    """
    t1 = emb[resident.ids.reshape(-1).long()]                 # (n*h1, m)
    return _block(resident, t1, q_ids[None], q_w[None], emb, bf16_matmul)[:, 0]


def rwmd_many_vs_many(resident: DocSet, queries: DocSet, emb, *,
                      bf16_matmul: bool = False,
                      query_chunk: int | None = None) -> torch.Tensor:
    """Symmetric quadratic RWMD, all resident docs x all query docs.

    Returns (n_resident, n_query) f32.  ``query_chunk`` bounds peak memory
    by taking the queries that many at a time; it must divide the number
    of queries, as in the reference.
    """
    nq = queries.n_docs
    t1 = emb[resident.ids.reshape(-1).long()]                 # (n*h1, m)
    if query_chunk is None:
        return _block(resident, t1, queries.ids, queries.weights, emb,
                      bf16_matmul)
    if nq % query_chunk != 0:
        raise ValueError(f"n_query={nq} not divisible by query_chunk={query_chunk}")
    return torch.cat([
        _block(resident, t1, queries.ids[lo:lo + query_chunk],
               queries.weights[lo:lo + query_chunk], emb, bf16_matmul)
        for lo in range(0, nq, query_chunk)], dim=1)
