"""Document clustering on LC-RWMD: greedy k-centers and k-medoids
(counterpart of ``repro.workloads.clustering``).

  * :func:`kcenters` — farthest-first traversal (the 2-approximation of the
    k-centers objective): one ``symmetric_resident`` column (B = 1) per
    center.
  * :func:`kmedoids` — PAM-style alternation.  The assignment either scores
    every medoid through one ``symmetric_resident`` block, or keeps the
    ``prefilter`` medoids nearest each doc by Word Centroid Distance and
    scores only those pairs by the quadratic RWMD (or batched Sinkhorn-WMD,
    ``rerank_wmd``).  The medoid update shortlists the members nearest each
    cluster's WCD centroid and takes the one whose summed symmetric bound
    to the cluster is smallest; all shortlists go through one block.
  * :func:`kmedoids_wcd_baseline` — the same alternation on WCD alone.

Unlike the reference, nothing here holds an (n, h, m) gather of the
resident docs' word embeddings: centroids come from
``wcd.resident_centroids`` (row chunks) and the prefiltered assignment
gathers each chunk's targets by id (``lc_rwmd.doc_targets``), so the pair
scorers see (``_ROWS``, h, m) at most.  The baseline's medoid update sums
each member's distances to the others ``_ROWS`` members at a time instead
of broadcasting (m_c, m_c, m).

Each distance that picks a center, a label or a medoid is computed by the
reference's own formula: exact differences where it takes
``np.linalg.norm`` of a difference (:func:`exact_dists`), the GEMM form of
``core/distances.dists`` where it calls ``dists``.  Ties take the first
index, as ``np.argmin`` / ``np.argmax`` do.

Tombstones (a :class:`~repro_torch.core.lc_rwmd.SegmentedEngine` with
deleted docs) are the one place the port departs from the reference:
there a deleted doc's +inf column distance wins k-centers' argmax, so every
later center is a dead doc and the partition collapses to one or two
cells.  Here a deleted doc is never a center or a medoid, is left out of
the medoid update and of the objective; on an engine without deletions
the results are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as topk_lib
from repro_torch.core.distances import dists
from repro_torch.core.lc_rwmd import doc_targets
from repro_torch.core.rwmd import rwmd_pairs_from_t
from repro_torch.core.wcd import resident_centroids
from repro_torch.core.wmd import wmd_batched_dispatch

_ROWS = 4096   # rows per chunk: (rows, h, m) targets, (rows, q) distances


class ClusterResult(NamedTuple):
    labels: np.ndarray     # (n,) int32 cluster assignment
    medoids: np.ndarray    # (k,) int32 medoid doc ids
    objective: float       # sum of assigned distances (RWMD or WMD)
    n_iters: int           # k-medoids iterations executed


def exact_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(p, q) Euclidean distances between the rows of ``a`` and ``b`` from
    their exact differences (``np.linalg.norm(a[:, None] - b[None], axis=2)``
    without the (p, q, m) difference tensor), ``_ROWS`` rows of ``a`` at a
    time."""
    return torch.cat([
        torch.cdist(a[lo:lo + _ROWS], b,
                    compute_mode="donot_use_mm_for_euclid_dist")
        for lo in range(0, a.shape[0], _ROWS)])


def live_mask(engine) -> np.ndarray | None:
    """The engine's (n,) host live mask, or None when every doc is live."""
    get = getattr(engine, "live_mask", None)
    live = None if get is None else get()
    return None if live is None or live.all() else live


def kcenters(engine, n_clusters: int, *, first: int | None = 0,
             seed: int | None = None) -> np.ndarray:
    """Greedy k-centers (farthest-first) seeding over the resident corpus.

    Returns (n_clusters,) int32 doc ids.  Each step adds the doc farthest
    (symmetric LC-RWMD) from the chosen set.  ``seed`` (or ``first=None``)
    draws the first center from numpy's PRNG, as the reference does, so
    the same corpus and seed give the same centers.  A deleted first
    center moves to the next live doc.
    """
    n = engine.resident.n_docs
    if not 1 <= n_clusters <= n:
        raise ValueError(f"need 1 <= n_clusters <= {n}, got {n_clusters}")
    if seed is not None or first is None:
        first = int(np.random.default_rng(0 if seed is None else seed)
                    .integers(0, n))
    live = live_mask(engine)
    dead = None
    if live is not None:
        if not live.any():
            raise ValueError("no live doc to cluster")
        order = np.roll(np.arange(n), -first)
        first = int(order[live[order]][0])
        dead = torch.from_numpy(~live).to(engine.device)
    centers = [int(first)]
    mind = torch.full((n,), float("inf"), device=engine.device)
    for _ in range(n_clusters - 1):
        col = engine.symmetric_resident([centers[-1]])[:, 0]
        mind = torch.minimum(mind, col)
        pick = mind if dead is None else mind.masked_fill(dead, -float("inf"))
        centers.append(int(torch.argmax(pick)))
    return np.asarray(centers, dtype=np.int32)


def _assign_prefiltered(engine, cen: torch.Tensor, medoids: torch.Tensor,
                        c: int, rerank_wmd: bool, sinkhorn_kw: dict):
    """WCD prefilter → candidate-pair RWMD (→ Sinkhorn-WMD) assignment,
    ``_ROWS`` docs at a time: (labels (n,) int32, dist (n,)) on the
    device.  ``medoids`` (k,) long doc ids."""
    docs, emb = engine.resident, engine.emb_full
    n = docs.n_docs
    cen_m = cen[medoids]
    labels, dist = [], []
    for lo in range(0, n, _ROWS):
        rows = torch.arange(lo, min(lo + _ROWS, n), device=cen.device)
        d_wcd = dists(cen[rows], cen_m)                       # (R, k)
        cand = topk_lib.topk_smallest(d_wcd, c).indices.long()  # medoid slots
        med_doc = medoids[cand]                               # (R, c) doc ids
        t1, w1 = doc_targets(docs, emb, rows)                 # (R, h, m)
        cols = []
        for j in range(c):
            t2, w2 = doc_targets(docs, emb, med_doc[:, j])
            if rerank_wmd:
                cols.append(wmd_batched_dispatch(
                    t1, w1, t2, w2, use_kernel=t1.is_cuda, **sinkhorn_kw))
            else:
                cols.append(rwmd_pairs_from_t(t1, w1, t2, w2))
        vals = torch.stack(cols, dim=1)                       # (R, c)
        best = torch.argmin(vals, dim=1, keepdim=True)
        labels.append(torch.gather(cand, 1, best)[:, 0])
        dist.append(torch.gather(vals, 1, best)[:, 0])
    return torch.cat(labels).to(torch.int32), torch.cat(dist)


def _objective(dist: torch.Tensor, live: np.ndarray | None) -> float:
    d = dist.cpu().numpy()
    return float(np.sum(d if live is None else d[live]))


def kmedoids(engine, n_clusters: int, *, n_iters: int = 8,
             prefilter: int | None = None, rerank_wmd: bool = False,
             sinkhorn_kw: dict | None = None, medoid_candidates: int = 4,
             init: np.ndarray | None = None,
             seed: int | None = None) -> ClusterResult:
    """k-medoids over the engine's resident corpus (see the module
    docstring).  Returns a :class:`ClusterResult`.

    ``prefilter``: WCD-nearest medoids scored per doc (None → all
    ``n_clusters`` through one ``symmetric_resident`` block).
    ``rerank_wmd``: score the candidate pairs by batched Sinkhorn-WMD
    (implies ``prefilter``; the kernel on the card, the batched solver on
    the CPU, as the reference); ``sinkhorn_kw`` its knobs.
    ``medoid_candidates``: shortlist size of the medoid update.  ``seed``
    goes to the :func:`kcenters` initializer (unless ``init`` is given).
    """
    n = engine.resident.n_docs
    dev = engine.device
    if rerank_wmd and prefilter is None:
        prefilter = n_clusters
    if prefilter is not None:
        prefilter = max(1, min(prefilter, n_clusters))
    cen = resident_centroids(engine.resident, engine.emb_full)   # (n, m)
    live = live_mask(engine)
    live_t = None if live is None else torch.from_numpy(live).to(dev)

    medoids = np.asarray(
        kcenters(engine, n_clusters, seed=seed) if init is None else init,
        dtype=np.int32)
    labels = np.zeros(n, dtype=np.int32)
    obj = float("inf")
    c_upd = medoid_candidates
    slots = torch.arange(n_clusters, device=dev)
    it = 0
    for it in range(1, n_iters + 1):
        med_t = torch.from_numpy(medoids.astype(np.int64)).to(dev)
        if prefilter is None:
            block = engine.symmetric_resident(med_t)          # (n, k)
            lab, dist = torch.argmin(block, dim=1), block.amin(dim=1)
        else:
            lab, dist = _assign_prefiltered(engine, cen, med_t, prefilter,
                                            rerank_wmd, sinkhorn_kw or {})
        labels = lab.cpu().numpy().astype(np.int32)
        obj = _objective(dist, live)

        # Medoid update: per cluster the live members nearest its WCD
        # centroid, then the one whose summed symmetric bound to the
        # cluster's members is smallest; all shortlists in one block.
        new_medoids = medoids.copy()
        shortlists = np.repeat(medoids[:, None], c_upd, axis=1).astype(np.int32)
        valid_len = np.zeros(n_clusters, dtype=np.int64)
        for j in range(n_clusters):
            members = labels == j
            if live is not None:
                members &= live
            if not members.any():
                continue  # an empty cluster keeps its medoid
            m_ids = np.nonzero(members)[0]
            cm = cen[torch.from_numpy(m_ids).to(dev)]
            d_c = torch.linalg.vector_norm(cm - cm.mean(dim=0), dim=1)
            order = torch.sort(d_c, stable=True).indices[:c_upd].cpu().numpy()
            short = m_ids[order]
            shortlists[j] = np.resize(short, c_upd)
            valid_len[j] = len(short)
        block = engine.symmetric_resident(
            torch.from_numpy(shortlists.reshape(-1).astype(np.int64)).to(dev))
        member = lab.to(dev).long()[:, None] == slots[None, :]   # (n, k)
        if live_t is not None:
            member &= live_t[:, None]
        costs = torch.where(member[:, :, None],
                            block.reshape(n, n_clusters, c_upd),
                            0.0).sum(dim=0).cpu().numpy()         # (k, c)
        for j in range(n_clusters):
            if valid_len[j]:
                new_medoids[j] = shortlists[j, int(np.argmin(
                    costs[j, :valid_len[j]]))]
        if np.array_equal(np.sort(new_medoids), np.sort(medoids)):
            medoids = new_medoids
            break
        medoids = new_medoids
    return ClusterResult(labels=labels, medoids=medoids, objective=obj,
                         n_iters=it)


def kmedoids_wcd_baseline(engine, n_clusters: int, *,
                          n_iters: int = 8) -> ClusterResult:
    """WCD-only k-medoids, the cheap baseline: the same alternation with
    every distance a centroid distance (exact differences, as the
    reference's ``np.linalg.norm``); no phase 1, no transport."""
    n = engine.resident.n_docs
    cen = resident_centroids(engine.resident, engine.emb_full)   # (n, m)

    # Farthest-first on WCD for seeding (mirrors kcenters).
    medoids = [0]
    mind = torch.full((n,), float("inf"), device=cen.device)
    for _ in range(n_clusters - 1):
        mind = torch.minimum(mind, torch.linalg.vector_norm(
            cen - cen[medoids[-1]], dim=1))
        medoids.append(int(torch.argmax(mind)))
    medoids = np.asarray(medoids, dtype=np.int32)

    labels = np.zeros(n, dtype=np.int32)
    obj = float("inf")
    it = 0
    for it in range(1, n_iters + 1):
        d = exact_dists(cen, cen[torch.from_numpy(medoids.astype(np.int64))
                                 .to(cen.device)])           # (n, k)
        labels = torch.argmin(d, dim=1).cpu().numpy().astype(np.int32)
        obj = float(np.sum(d.amin(dim=1).cpu().numpy()))
        new_medoids = medoids.copy()
        for j in range(n_clusters):
            m_ids = np.nonzero(labels == j)[0]
            if not len(m_ids):
                continue
            cm = cen[torch.from_numpy(m_ids).to(cen.device)]
            cost = torch.cat([exact_dists(cm[lo:lo + _ROWS], cm).sum(dim=1)
                              for lo in range(0, len(m_ids), _ROWS)])
            new_medoids[j] = m_ids[int(torch.argmin(cost))]
        if np.array_equal(np.sort(new_medoids), np.sort(medoids)):
            medoids = new_medoids
            break
        medoids = new_medoids
    return ClusterResult(labels=labels, medoids=medoids, objective=obj,
                         n_iters=it)


# ---------------------------------------------------------------------------
# Clustering quality metrics (host-side, label-permutation invariant)
# ---------------------------------------------------------------------------
def purity(pred: np.ndarray, true: np.ndarray) -> float:
    """Fraction of docs in their cluster's majority class."""
    pred = np.asarray(pred)
    true = np.asarray(true)
    total = 0
    for c in np.unique(pred):
        members = true[pred == c]
        total += np.bincount(members).max()
    return float(total / len(true))


def adjusted_rand_index(pred: np.ndarray, true: np.ndarray) -> float:
    """ARI from the pair-counting contingency table (no sklearn)."""
    pred = np.asarray(pred)
    true = np.asarray(true)
    n = len(true)
    cats_p, pred_i = np.unique(pred, return_inverse=True)
    cats_t, true_i = np.unique(true, return_inverse=True)
    table = np.zeros((len(cats_p), len(cats_t)), dtype=np.int64)
    np.add.at(table, (pred_i, true_i), 1)

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(table).sum()
    sum_a = comb2(table.sum(axis=1)).sum()
    sum_b = comb2(table.sum(axis=0)).sum()
    expected = sum_a * sum_b / comb2(n)
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))
