"""Top-k smallest-distance selection: local, streaming and across ranks.

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
    """k smallest (distance, index) pairs per row, lexicographic ascending.

    Distances in ``torch.sort``'s order (+inf after every finite value, NaN
    after +inf), ties by index.  An unfilled slot (index ``EMPTY_IDX``)
    ranks after every real entry, +inf and NaN included, whatever its
    distance: the CPU fold's (+inf, -1) and the fused top-k kernel's
    (3.4e38, -1) alike.  Two stable sorts: by index, with the unfilled slots
    keyed last, then by distance, with those slots keyed NaN (so among the
    NaNs they stay last).  Every NaN is keyed alike and -0 as +0: on CUDA
    ``torch.sort`` orders floats by their bits (a radix sort), which would
    part NaNs of different payloads, and -0 from +0, instead of leaving
    them tied.
    """
    idx = indices.to(torch.int32)
    empty = idx < 0
    nan = torch.full((), float("nan"), device=dists.device)
    first = torch.sort(idx.masked_fill(empty, torch.iinfo(torch.int32).max),
                       dim=-1, stable=True).indices
    key = torch.where(empty | torch.isnan(dists), nan, dists + 0.0)
    order = torch.gather(first, -1, torch.sort(
        torch.gather(key, -1, first), dim=-1, stable=True).indices[..., :k])
    return TopK(dists=torch.gather(dists, -1, order),
                indices=torch.gather(idx, -1, order))


def masked_entries(d: torch.Tensor, rows: torch.Tensor,
                   row_valid: torch.Tensor | None = None,
                   q_gid: torch.Tensor | None = None):
    """A (B, R) block ``d`` of resident rows ``rows`` (R,) as the (dists,
    ids) a fold takes.  The entries of a row whose ``row_valid`` (R,) is
    False (a tombstone), and the pair (row ``q_gid[j]``, query j)
    (self-exclusion), become unfilled slots (+inf, ``EMPTY_IDX``): left out
    by their flag, so never ranked before a real +inf or NaN distance."""
    ids = rows.to(torch.int32)[None, :].expand(d.shape)
    keep = None if row_valid is None else row_valid[None, :]
    if q_gid is not None:
        own = ids != q_gid[:, None]
        keep = own if keep is None else keep & own
    if keep is None:
        return d, ids
    return (d.masked_fill(~keep, float("inf")),
            torch.where(keep, ids, torch.full((), EMPTY_IDX, dtype=torch.int32,
                                              device=ids.device)))


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


def _filler(device: torch.device) -> float:
    """An unfilled slot's distance: the fused top-k kernel's 3.4e38 on
    CUDA, the fold's +inf on the CPU (either ranks last by its id)."""
    return 3.4e38 if device.type == "cuda" else float("inf")


def pad_topk(tk: TopK, k: int, fill: float = float("inf")) -> TopK:
    """``tk`` widened to ``k`` columns with unfilled slots (``fill``, -1)."""
    pad = k - tk.dists.shape[-1]
    if pad <= 0:
        return tk
    return TopK(torch.nn.functional.pad(tk.dists, (0, pad), value=fill),
                torch.nn.functional.pad(tk.indices, (0, pad),
                                        value=EMPTY_IDX))


def crossshard_topk(local: TopK, k: int, *, mesh,
                    axis_names: Sequence[str]) -> TopK:
    """Merge per-rank (B, k̃) candidates into a global TopK that every rank
    of ``mesh`` holds.

    ``local.indices`` must already be GLOBAL doc ids.  Each rank's partial
    is padded to (B, k) with unfilled slots (a shard may hold fewer than k
    rows), so every gather has one shape; the (distance, id) pairs travel
    as one int32 tensor, one ``all_gather`` per named axis of size > 1.
    """
    local = pad_topk(local, k, _filler(local.dists.device))
    packed = torch.stack([local.dists.to(torch.float32).contiguous().view(
        torch.int32), local.indices.to(torch.int32)])
    packed = mesh.all_gather(packed, axis_names, dim=-1)
    return lex_smallest(packed[0].view(torch.float32), packed[1], k)


def distributed_topk(local_d: torch.Tensor, k: int, *, mesh,
                     axis_names: Sequence[str], shard_offset: int) -> TopK:
    """Global top-k of row-sharded distances: ``local_d`` is this rank's
    (n_local, B) block, whose row 0 is global row ``shard_offset``.  The
    result is held by every rank of ``axis_names``."""
    local = topk_smallest(local_d.T, min(k, local_d.shape[0]))   # (B, k̃)
    local = TopK(local.dists, local.indices + int(shard_offset))
    return crossshard_topk(local, k, mesh=mesh, axis_names=axis_names)
