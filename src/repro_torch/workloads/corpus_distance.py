"""Tiled set-vs-set LC-RWMD: the corpus-analytics scheduler (counterpart of
``repro.workloads.corpus_distance``).

Self all-pairs (the clustering / dedup substrate)
-------------------------------------------------
The corpus is cut into ``T = ⌈n/tile⌉`` query-side tiles.  Phase 1 runs
ONCE per tile against the engine's restricted vocabulary
(:meth:`~repro_torch.core.LCRWMDEngine.phase1_resident`, the phase-1
kernel on the card): ``Z_t`` of shape (v_e, tile).  The symmetric bound of
an (s, t) block pair is then two phase-2 SpMMs over the blocks' rows
(:meth:`one_sided_rows`, the ELL SpMM kernel on the card)::

    D_sym[rows_s, cols_t] = max(phase2(rows_s, Z_t), phase2(rows_t, Z_s)ᵀ)

so only UNORDERED pairs ``s ≤ t`` are visited (the transpose covers the
mirrored block), the diagonal of ``s == t`` blocks and every dead row and
column are masked (+inf, and left out of a top-k by their flag), and each
block's per-row candidates fold into a running (tile, k) state per row
tile.  The (n, n) matrix never exists; the peak intermediates are the
(v_e, n) phase-1 cache, n·v_e·4 bytes, and (tile, tile) blocks.

The last tile is ragged, at its real size: the reference pads it so that
one jit trace serves every tile; eager PyTorch traces nothing and the
kernels take any shape, so nothing is padded and no padded column needs
masking.

Cross-set (corpus-vs-resident)
------------------------------
An external corpus streams through ``engine.symmetric`` (phase 1, the ELL
SpMM and the swapped direction's d21 mode on the card) in query tiles:
per-query top-k rows concatenate, and the optional resident-side view
keeps a running per-resident top-k merged across tiles.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from repro_torch.core import topk as topk_lib
from repro_torch.data.docs import DocSet

_INF = float("inf")


class TileBlock(NamedTuple):
    """One symmetric distance block from the self-pair scheduler."""
    s: int                 # row-tile index
    t: int                 # column-tile index (s <= t)
    row_idx: torch.Tensor  # (R,) global doc ids of the block rows
    col_idx: torch.Tensor  # (C,) global doc ids of the block columns
    block: torch.Tensor    # (R, C) symmetric LC-RWMD; +inf where masked
    mirrored: bool         # True when (col, row) is NOT visited separately
    keep: torch.Tensor     # (R, C) bool: False at the diagonal, dead rows
    #                        and dead columns (the masked entries)


def _tile_starts(n: int, tile: int) -> list[int]:
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return list(range(0, n, tile))


def _live(engine) -> torch.Tensor | None:
    """The engine's (n,) device live mask (a SegmentedEngine's), or None."""
    return (engine.live_mask_device() if hasattr(engine, "live_mask_device")
            else None)


class SelfPairScheduler:
    """Pair-tiled symmetric all-pairs scan over an engine's resident corpus.

    Holds the per-tile phase-1 cache and the block step; consumers (top-k,
    threshold graphs) iterate :meth:`blocks`.  A segmented engine's live
    mask is read once, at construction (the phase-1 cache is a snapshot of
    that version anyway): a dead doc's row AND column are masked, so it has
    no neighbours and is no one's neighbour.
    """

    def __init__(self, engine, *, tile: int = 64):
        self.engine = engine
        self.n = engine.resident.n_docs
        self.tile = min(tile, self.n)
        self.starts = _tile_starts(self.n, self.tile)
        self._z: list = []  # phase-1 cache, one Z (or per-segment tuple) a tile
        self._live = _live(engine)

    def _tile_idx(self, lo: int) -> torch.Tensor:
        """Global ids of the tile starting at ``lo`` (the last one ragged)."""
        return torch.arange(lo, min(lo + self.tile, self.n),
                            device=self.engine.device)

    def _step(self, z_s, z_t, idx_s: torch.Tensor, idx_t: torch.Tensor):
        """(block, keep): max(D1[rows_s, cols_t], D1[rows_t, cols_s]ᵀ),
        +inf where masked, and the mask's complement."""
        b_st = self.engine._one_sided_rows_impl(idx_s, z_t)  # (R, C)
        b_ts = self.engine._one_sided_rows_impl(idx_t, z_s)  # (C, R)
        sym = torch.maximum(b_st, b_ts.T)
        keep = idx_s[:, None] != idx_t[None, :]
        if self._live is not None:
            keep &= self._live[idx_s][:, None] & self._live[idx_t][None, :]
        return sym.masked_fill(~keep, _INF), keep

    def _z_tile(self, t: int):
        while len(self._z) <= t:
            lo = self.starts[len(self._z)]
            self._z.append(self.engine.phase1_resident(self._tile_idx(lo)))
        return self._z[t]

    def blocks(self) -> Iterator[TileBlock]:
        """Yield every s ≤ t block; s > t is skipped (covered by transpose)."""
        for t, t_lo in enumerate(self.starts):
            z_t = self._z_tile(t)
            idx_t = self._tile_idx(t_lo)
            for s in range(t + 1):
                idx_s = self._tile_idx(self.starts[s])
                block, keep = self._step(self._z[s], z_t, idx_s, idx_t)
                yield TileBlock(s=s, t=t, row_idx=idx_s, col_idx=idx_t,
                                block=block, mirrored=s < t, keep=keep)


def _fold_block(stk: topk_lib.StreamingTopK, carry: topk_lib.TopK,
                block: torch.Tensor, col_gids: torch.Tensor,
                keep: torch.Tensor | None = None) -> topk_lib.TopK:
    """Fold one (R, C) block row-wise into the shared streaming carry; the
    entries that ``keep`` marks False go in as unfilled slots."""
    ids = col_gids.to(torch.int32)[None, :].expand(block.shape)
    if keep is not None:
        ids = torch.where(keep, ids, topk_lib.EMPTY_IDX)
    return stk.update(carry, block, ids)


def corpus_self_topk(engine, k: int, *, tile: int = 64) -> topk_lib.TopK:
    """Per-document k nearest neighbours over the engine's own corpus.

    Exact symmetric LC-RWMD top-k (self excluded), computed by the
    pair-tiled scheduler: every block folds into a
    :class:`~repro_torch.core.topk.StreamingTopK` carry per row tile, so the
    peak distance intermediate is one (tile, tile) block.  A dead doc's row
    is all unfilled slots (+inf, -1).

    Returns a TopK of (n, k): ascending distances, global doc ids.
    """
    n = engine.resident.n_docs
    n_eff = getattr(engine, "n_live", n)  # tombstones can't be neighbours
    if not 1 <= k <= n_eff - 1:
        raise ValueError(f"need 1 <= k <= n_live-1 = {n_eff - 1}, got {k}")
    sched = SelfPairScheduler(engine, tile=max(tile, k))
    stk = topk_lib.StreamingTopK(k)
    state = [stk.init(min(sched.tile, n - lo), device=engine.device)
             for lo in sched.starts]
    for blk in sched.blocks():
        state[blk.s] = _fold_block(stk, state[blk.s], blk.block, blk.col_idx,
                                   blk.keep)
        if blk.mirrored:
            state[blk.t] = _fold_block(stk, state[blk.t], blk.block.T,
                                       blk.row_idx, blk.keep.T)
    return topk_lib.TopK(dists=torch.cat([st.dists for st in state]),
                         indices=torch.cat([st.indices for st in state]))


class CorpusTopKResult(NamedTuple):
    query_topk: topk_lib.TopK              # (n_corpus, k) over resident docs
    resident_topk: topk_lib.TopK | None    # (n_resident, k) over corpus docs


def corpus_vs_corpus_topk(engine, corpus: DocSet, k: int, *, tile: int = 64,
                          resident_side: bool = False) -> CorpusTopKResult:
    """Per-corpus-doc top-k over the engine's resident set, streamed in tiles.

    Each query tile produces one (n_resident, tile) symmetric block through
    the engine; per-query top-k rows concatenate directly.  With
    ``resident_side=True`` the same stream also keeps the transposed view,
    per-RESIDENT top-k over the corpus, as a running merge across tiles, so
    neither orientation ever materializes (n_resident, n_corpus).  A
    segmented engine's dead rows are left out of both views by their flag.
    """
    n_q = corpus.n_docs
    n_r = engine.resident.n_docs
    k_q = min(k, n_r)       # per-query columns are resident docs
    k_res = min(k, n_q)     # per-resident columns are corpus docs
    tile = min(max(tile, k_res), n_q)
    corpus = corpus.to(engine.device)
    live = _live(engine)
    rows = torch.arange(n_r, dtype=torch.int32, device=engine.device)
    q_rows: list[topk_lib.TopK] = []
    stk = topk_lib.StreamingTopK(k_res)
    running = stk.init(n_r, device=engine.device) if resident_side else None
    ids = rows if live is None else torch.where(live, rows, topk_lib.EMPTY_IDX)
    for lo in _tile_starts(n_q, tile):
        d = engine.symmetric(corpus.slice_rows(lo, tile))      # (n_r, T)
        q_rows.append(topk_lib.lex_smallest(
            d.T, ids[None, :].expand(d.shape[1], n_r), k_q))
        if resident_side:
            col_gid = torch.arange(lo, lo + d.shape[1], device=engine.device)
            running = _fold_block(
                stk, running, d, col_gid,
                None if live is None else live[:, None].expand(d.shape))
    q_tk = topk_lib.TopK(dists=torch.cat([p.dists for p in q_rows]),
                         indices=torch.cat([p.indices for p in q_rows]))
    return CorpusTopKResult(query_topk=q_tk, resident_topk=running)


def corpus_self_topk_distributed(engine, mesh, k: int, *, tile: int = 64,
                                 refine: bool = True, rerank_wmd: bool = False,
                                 wmd_kw: dict | None = None,
                                 bf16_matmul: bool = False) -> topk_lib.TopK:
    """Self-corpus kNN, one resident tile a serve step.

    Streams resident tiles as query batches through the engine-backed serve
    step (:func:`repro_torch.distributed.lcrwmd_dist.build_serve_step`,
    ``self_exclude=True``) on ``mesh`` (``None``: one device; under a mesh
    every rank calls this and gets the same result): the candidate cascade
    (one-sided top-k → symmetric refine → optional Sinkhorn rerank) matches
    serving semantics, so the returned distances are exact symmetric RWMD
    (or WMD) for the returned pairs.  A ``SegmentedEngine`` runs the
    segmented step's mesh program on any mesh; every rank holds the same
    engine.
    """
    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    n = engine.resident.n_docs
    tile = min(tile, n)
    serve = build_serve_step(mesh, k=k, engine=engine, refine=refine,
                             bf16_matmul=bf16_matmul, rerank_wmd=rerank_wmd,
                             wmd_kw=wmd_kw, self_exclude=True)
    parts: list[topk_lib.TopK] = []
    for lo in _tile_starts(n, tile):
        idx = torch.arange(lo, min(lo + tile, n), device=engine.device)
        parts.append(serve(engine.resident_tile(idx), query_ids=idx).topk)
    return topk_lib.TopK(dists=torch.cat([p.dists for p in parts]),
                         indices=torch.cat([p.indices for p in parts]))


__all__ = ["CorpusTopKResult", "SelfPairScheduler", "TileBlock",
           "corpus_self_topk", "corpus_self_topk_distributed",
           "corpus_vs_corpus_topk"]
