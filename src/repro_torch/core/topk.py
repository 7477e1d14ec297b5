"""Top-k smallest-distance selection, local and streaming.

Every selection and merge shares ONE tie-break contract with the reference:
candidates are ordered by the lexicographic key ``(distance, global doc id)``
ascending.  ``torch.topk`` promises no order among equal values, so every
selection here is a two-key order instead: a stable sort by index, then a
stable sort by distance.  A :class:`StreamingTopK` fold over row blocks is
then exactly equal, ties included, to a selection over the materialized
matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)

EMPTY_IDX = -1  # index sentinel of unfilled carry slots (dist = +inf)


class TopK(NamedTuple):
    dists: torch.Tensor    # (..., k) ascending distances
    indices: torch.Tensor  # (..., k) GLOBAL resident-doc indices (int32)


def lex_smallest(dists: torch.Tensor, indices: torch.Tensor, k: int) -> TopK:
    """k smallest (distance, index) pairs per row, lexicographic ascending."""
    idx = indices.to(torch.int32)
    order = torch.sort(idx, dim=-1, stable=True).indices
    d = torch.gather(dists, -1, order)
    i = torch.gather(idx, -1, order)
    order = torch.sort(d, dim=-1, stable=True).indices[..., :k]
    return TopK(dists=torch.gather(d, -1, order),
                indices=torch.gather(i, -1, order))


class StreamingTopK:
    """Running top-k-smallest merge with a fixed-size (..., k) carry.

    ``init`` builds an empty carry of +inf distances and ``EMPTY_IDX`` ids,
    ``update`` folds a block of candidate (distance, global id) pairs in, and
    the carry itself is always a valid, ascending :class:`TopK`.
    """

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"k must be positive, got {k}")
        self.k = k

    def init(self, *batch_shape: int, device=None) -> TopK:
        """Empty carry of shape (*batch_shape, k)."""
        shape = (*batch_shape, self.k)
        return TopK(
            dists=torch.full(shape, float("inf"), dtype=torch.float32,
                             device=device),
            indices=torch.full(shape, EMPTY_IDX, dtype=torch.int32,
                               device=device),
        )

    def update(self, carry: TopK, dists: torch.Tensor,
               indices: torch.Tensor) -> TopK:
        """Fold (..., c) candidate pairs into the (..., k) carry."""
        d = torch.cat([carry.dists, dists.to(torch.float32)], dim=-1)
        i = torch.cat([carry.indices, indices.to(torch.int32)], dim=-1)
        return lex_smallest(d, i, self.k)

    def update_cols(self, carry: TopK, d_block: torch.Tensor,
                    row_gids: torch.Tensor) -> TopK:
        """Fold a resident-major (R, B) phase-2 block into a (B, k) carry."""
        r, b = d_block.shape
        idx = row_gids.to(torch.int32)[None, :].expand(b, r)
        return self.update(carry, d_block.T, idx)

    def update_rows(self, carry: TopK, block: torch.Tensor,
                    col_gids: torch.Tensor) -> TopK:
        """Fold a (R, C) block row-wise into an (R, k) carry."""
        r, c = block.shape
        idx = col_gids.to(torch.int32)[None, :].expand(r, c)
        return self.update(carry, block, idx)


def topk_smallest(d: torch.Tensor, k: int) -> TopK:
    """Per-row k smallest entries of d (..., n) → TopK of (..., k).

    Equal values order by ascending position, as ``lax.top_k`` does.
    """
    pos = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    return lex_smallest(d, pos.expand(d.shape), k)


def topk_smallest_cols(d: torch.Tensor, k: int) -> TopK:
    """Per-QUERY top-k over the resident axis of an (n_resident, B) matrix."""
    return topk_smallest(d.T, k)  # (B, k)


def topk_from_candidates(vals: torch.Tensor, cand_indices: torch.Tensor,
                         k: int) -> TopK:
    """Top-k of per-candidate values, mapped back to global doc ids.

    vals (B, budget) distances for the candidates named by ``cand_indices``
    (B, budget); returns a TopK of (B, min(k, budget)) with global ids.
    """
    final = topk_smallest(vals, min(k, vals.shape[-1]))
    return TopK(
        final.dists,
        torch.gather(cand_indices, -1, final.indices.long()).to(torch.int32),
    )


def merge_topk(parts: Sequence[TopK], k: int) -> TopK:
    """Merge several TopK candidate sets (same leading dims) into one."""
    d = torch.cat([p.dists for p in parts], dim=-1)
    i = torch.cat([p.indices for p in parts], dim=-1)
    return lex_smallest(d, i, k)
