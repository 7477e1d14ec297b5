"""Near-duplicate graphs from the tiled all-pairs stream, and the ingest
dedup gate (counterpart of ``repro.workloads.neighbors``).

:func:`near_duplicate_graph` consumes the
:class:`~repro_torch.workloads.corpus_distance.SelfPairScheduler` block
stream: each symmetric block is thresholded on its device and only the
survivors (their positions and distances, a ``nonzero``) are copied to the
host.  The reference compacts into a fixed-size survivor list so that its
jit program keeps one shape, with a host fallback for a block that
overflows; eager PyTorch keeps no shape, so there is no cap and no
fallback.

Graphs are undirected and stored with BOTH orientations (CSR rows are
complete neighbor lists).  ``threshold`` is in symmetric LC-RWMD units — a
LOWER bound on WMD, so a near-duplicate edge here is a superset of the true
WMD near-duplicates at the same threshold (no false dismissals); the same
holds for the ingest gate (no false admits).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np

from repro_torch.core.lc_rwmd import lc_rwmd_symmetric
from repro_torch.workloads.corpus_distance import (SelfPairScheduler,
                                                   corpus_self_topk)

#: Numeric noise floor of the symmetric LC-RWMD score for EXACT copies.
#: Phase-1 distances come from the matmul form ``||a||² + ||b||² − 2ab``
#: whose cancellation error survives the sqrt, so identical docs score
#: ~7e-4 — NOT 0.  Thresholds below this floor silently miss exact
#: duplicates; :func:`near_duplicate_graph` and :func:`ingest_dedup_mask`
#: clamp up to it (with a warning) instead of failing silently.
DUPLICATE_SCORE_FLOOR: float = 1e-2


def _floor_threshold(threshold: float, caller: str) -> float:
    """Validate/clamp a near-duplicate threshold against the noise floor."""
    if not threshold > 0.0:
        raise ValueError(
            f"{caller}: threshold must be > 0, got {threshold!r}")
    if threshold < DUPLICATE_SCORE_FLOOR:
        warnings.warn(
            f"{caller}: threshold {threshold:g} is below the symmetric "
            f"LC-RWMD numeric noise floor ({DUPLICATE_SCORE_FLOOR:g}); "
            f"exact duplicates score ~7e-4, not 0, so this threshold would "
            f"silently miss them.  Clamping to {DUPLICATE_SCORE_FLOOR:g}.",
            stacklevel=3)
        return DUPLICATE_SCORE_FLOOR
    return threshold


def ingest_dedup_mask(engine, docs, threshold: float, *,
                      intra_batch: bool = True) -> np.ndarray:
    """(B,) bool gate for ingest: True where a doc is NOT a near-duplicate.

    Each incoming doc is scored by symmetric LC-RWMD against the engine's
    live corpus (``engine.symmetric``: an (n, B) matrix, tombstoned rows
    +inf, so a deleted doc can't block an ingest; on the card phase 1, the
    ELL SpMM and the d21 mode), reduced to its column minima on the
    engine's device, and docs within ``threshold`` of an existing doc are
    dropped.  ``intra_batch=True`` also de-dups WITHIN the batch (first
    occurrence wins).  Thresholds below :data:`DUPLICATE_SCORE_FLOOR` are
    clamped up to it with a warning.
    """
    threshold = _floor_threshold(threshold, "ingest_dedup_mask")
    b = docs.n_docs
    keep = np.ones(b, dtype=bool)
    docs = docs.to(engine.device)
    if engine.n_live:
        d_min = engine.symmetric(docs).amin(dim=0)           # (B,)
        keep &= d_min.cpu().numpy() > threshold
    if intra_batch and b > 1:
        dd = lc_rwmd_symmetric(docs, docs, engine.emb_full).cpu().numpy()
        for j in range(1, b):
            if keep[j] and bool((dd[:j, j][keep[:j]] <= threshold).any()):
                keep[j] = False
    return keep


class NeighborGraph(NamedTuple):
    """CSR adjacency over corpus docs (undirected, both orientations)."""
    indptr: np.ndarray    # (n+1,) int64 row pointers
    indices: np.ndarray   # (nnz,) int32 neighbor doc ids
    data: np.ndarray      # (nnz,) f32 symmetric LC-RWMD distances
    n_docs: int

    @property
    def n_edges(self) -> int:
        """Undirected edge count (each stored twice in CSR)."""
        return len(self.indices) // 2

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)


def _edges_to_csr(rows, cols, vals, n: int) -> NeighborGraph:
    rows = np.concatenate(rows) if rows else np.empty(0, np.int64)
    cols = np.concatenate(cols) if cols else np.empty(0, np.int64)
    vals = np.concatenate(vals) if vals else np.empty(0, np.float32)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return NeighborGraph(indptr=indptr, indices=cols.astype(np.int32),
                         data=vals.astype(np.float32), n_docs=n)


def near_duplicate_graph(engine, threshold: float, *, tile: int = 64,
                         block_edge_cap: int | None = None) -> NeighborGraph:
    """All doc pairs with symmetric LC-RWMD ≤ ``threshold``, as CSR.

    One pass over the s ≤ t tile pairs; mirrored blocks contribute both
    orientations from the same block (the s == t diagonal block already
    holds both and its self-distance diagonal is masked +inf, so identical
    docs link without self-loops).  Each block is thresholded on its device
    and only its survivors are copied to the host.

    ``block_edge_cap`` is accepted for the reference's signature and bounds
    nothing: the reference sizes a fixed survivor list with it (its jit
    program keeps one shape); here every survivor is copied, however many.
    """
    del block_edge_cap
    threshold = _floor_threshold(threshold, "near_duplicate_graph")
    n = engine.resident.n_docs
    sched = SelfPairScheduler(engine, tile=tile)
    rows, cols, vals = [], [], []
    for blk in sched.blocks():
        r, c = (blk.block <= threshold).nonzero(as_tuple=True)  # +inf never
        if r.numel() == 0:
            continue
        d = blk.block[r, c].cpu().numpy()
        gi = blk.row_idx[r].cpu().numpy().astype(np.int64)
        gj = blk.col_idx[c].cpu().numpy().astype(np.int64)
        rows.append(gi)
        cols.append(gj)
        vals.append(d)
        if blk.mirrored:  # s < t: the (t, s) block is never visited
            rows.append(gj)
            cols.append(gi)
            vals.append(d)
    return _edges_to_csr(rows, cols, vals, n)


def knn_graph(engine, k: int, *, tile: int = 64,
              mutual: bool = False) -> NeighborGraph:
    """k-nearest-neighbor graph from the tiled top-k pass, symmetrized.

    ``mutual=False`` keeps an edge if EITHER endpoint ranks the other in its
    top-k (union symmetrization); ``mutual=True`` requires BOTH (the
    classic near-duplicate criterion — robust to hubness).  The reference's
    Python sets and dicts are numpy here; an arc's value is the last one
    written in (source, rank) order, as in the reference's dict.
    """
    tk = corpus_self_topk(engine, k, tile=tile)
    idx = tk.indices.cpu().numpy()
    d = tk.dists.cpu().numpy()
    n = engine.resident.n_docs
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    dst = idx.reshape(-1).astype(np.int64)
    w = d.reshape(-1).astype(np.float32)
    real = dst >= 0           # a dead doc's row holds only unfilled slots
    src, dst, w = src[real], dst[real], w[real]
    if mutual:
        keep = np.isin(dst * n + src, src * n + dst)
        src, dst, w = src[keep], dst[keep], w[keep]
    if src.size == 0:
        return _edges_to_csr([], [], [], n)
    # Union-symmetrize: each arc and its reverse, in the reference's write
    # order; the last write of a pair wins.
    a = np.stack([src, dst], 1).reshape(-1)
    b = np.stack([dst, src], 1).reshape(-1)
    v = np.repeat(w, 2)
    key = a * n + b
    _, last = np.unique(key[::-1], return_index=True)
    last = key.size - 1 - last
    return _edges_to_csr([a[last]], [b[last]], [v[last]], n)


def connected_components(graph: NeighborGraph) -> np.ndarray:
    """(n,) int32 component label per doc — near-duplicate groups."""
    n = graph.n_docs
    parent = np.arange(n)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in graph.indices[graph.indptr[i]:graph.indptr[i + 1]]:
            ri, rj = find(i), find(int(j))
            if ri != rj:
                parent[max(ri, rj)] = min(ri, rj)
    roots = np.fromiter((find(i) for i in range(n)), np.int64, n)
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def duplicate_groups(graph: NeighborGraph) -> list[np.ndarray]:
    """Connected components with ≥ 2 docs, largest first (ties in label
    order), each ascending.  One stable sort of the labels, where the
    reference scans the labels once per component."""
    labels = connected_components(graph)
    order = np.argsort(labels, kind="stable")
    groups = np.split(order, np.cumsum(np.bincount(labels))[:-1])
    return sorted((g for g in groups if len(g) >= 2), key=len, reverse=True)


__all__ = ["DUPLICATE_SCORE_FLOOR", "NeighborGraph", "connected_components",
           "duplicate_groups", "ingest_dedup_mask", "knn_graph",
           "near_duplicate_graph"]
