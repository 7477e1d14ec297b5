"""Cluster-routed index: cell partitioning, routing and routed top-k
(counterpart of ``repro.index.cluster_index``).

  * **Partition** — k-centers seeds plus one WCD assignment pass, or full
    k-medoids labels (:mod:`repro_torch.workloads.clustering`), from an
    explicit ``seed``: a rebuild over the same corpus lands on the same
    cells.
  * **Cells** — each non-empty cell is an
    :class:`~repro_torch.core.lc_rwmd.EngineSegment` over its members
    (ascending global ids) at its own size, with its own restricted
    vocabulary, plus a device table of its members' global ids.  The
    reference pads every cell to one (rows_cap, v_cap) shape and gives an
    empty cell a one-row placeholder so that one jit trace serves every
    cell; eager PyTorch traces nothing and the kernels take any shape, so
    here nothing is padded and empty cells are skipped (not alive).
  * **Routing** — query WCD centroids, their distances to the cell means,
    the top-``p`` cells in (distance, cell) order, and the triangle bound:
    for any member d of cell c, ``WMD(q, d) ≥ WCD(q, d) ≥ |q − μ_c| − r_c``.
    Routed cells whose bound exceeds ``bound_slack ×`` the best routed
    match's upper bound are pruned before phase 1.
  * **Routed top-k** — each probed cell runs the streaming symmetric fold
    (phase 1 over the cell's vocabulary, the d21 mode, the fused top-k
    with the cell's live mask) on the queries routed to it only; local ids
    map through the cell's gid table and the parts merge in the
    lexicographic (distance, global id) order of the flat scan, so
    exhaustive routing (``top_p = num_cells``, bound off) equals
    ``engine.topk`` bit for bit.

Tombstones stay the engine's business: the cells' live masks and means are
re-derived from ``engine.live_mask()`` whenever ``engine.version`` moves,
so a delete made on the engine is honoured without an index call.  Doc
centroids live on the device as one (n, m) tensor
(``wcd.resident_centroids``); no (n, h, m) gather and no (n, C, m)
broadcast is built.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.distances import dists
from repro_torch.core.lc_rwmd import EngineSegment, _segment_topk
from repro_torch.core.topk import TopK, merge_topk, pad_topk, topk_smallest
from repro_torch.core.wcd import centroids_from_t, resident_centroids
from repro_torch.data.docs import DocSet
from repro_torch.workloads.clustering import exact_dists

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Knobs for building and using a :class:`ClusterIndex`.

    ``num_cells``: cell count.  ``top_p``: cells probed per query.
    ``seed``: the partition's PRNG seed (a rebuild reproduces the cells).
    ``bound_slack``: triangle-bound pruning slack (≥ 1.0 keeps every cell
    that could hold the single best match; None disables the bound).
    ``probe_cap``: the most distinct cells one batch may probe in the
    routed serve step; overflow drops the least-requested cells.  None →
    ``min(num_cells, max(8, 4·top_p))``.  ``method``: ``"kcenters"``
    (greedy seeds + one WCD assignment pass) or ``"kmedoids"``.
    """

    num_cells: int
    top_p: int = 1
    seed: int = 0
    bound_slack: float | None = None
    probe_cap: int | None = None
    method: str = "kcenters"

    def __post_init__(self):
        if self.num_cells < 1:
            raise ValueError(f"num_cells must be >= 1, got {self.num_cells}")
        if self.top_p < 1:
            raise ValueError(f"top_p must be >= 1, got {self.top_p}")
        if self.bound_slack is not None and self.bound_slack <= 0:
            raise ValueError(
                f"bound_slack must be positive or None, got {self.bound_slack}")
        if self.method not in ("kcenters", "kmedoids"):
            raise ValueError(f"unknown partition method {self.method!r}")


class RouteResult(NamedTuple):
    """Host-side routing decision for one query batch."""
    cells: np.ndarray        # (B, p) int32 routed cell ids (by distance)
    keep: np.ndarray         # (B, p) bool: slot survived bound + validity
    probed: np.ndarray       # (P,) int64 distinct cells any query kept
    n_bound_pruned: int      # (query, cell) slots killed by the bound stage
    n_docs_pruned: int       # live docs those pruned slots would have scanned


class _Cell(NamedTuple):
    """One non-empty cell's device state, at its own size."""
    segment: EngineSegment   # offset 0, one row per member
    members: np.ndarray      # (n_c,) int64 global doc ids, ASCENDING
    gids: torch.Tensor       # (n_c,) int32 global ids on the device


def _route_cells(mu, radii, alive, c_q, p: int):
    """Top-p cells by query-centroid → cell-centroid distance, and bounds:
    (d (B, p) ascending, cells (B, p), lb (B, p) triangle lower bound on
    any member's WCD, ub_best (B,) upper bound on the best routed match's
    WCD)."""
    d = dists(c_q, mu).masked_fill(~alive[None, :], _INF)      # (B, C)
    tk = topk_smallest(d, p)
    r = radii[tk.indices.long()]                                # (B, p)
    lb = torch.clamp(tk.dists - r, min=0.0)
    ub_best = torch.where(tk.dists < _INF, tk.dists + r,
                          torch.full_like(r, _INF)).amin(dim=1)
    return tk.dists, tk.indices, lb, ub_best


class ClusterIndex:
    """IVF-style cell index over a :class:`~repro_torch.core.lc_rwmd.SegmentedEngine`.

    The engine stays the source of truth for docs, global ids, tombstones
    and the rerank; the index is an acceleration structure beside it
    (``nbytes`` reports the device bytes it holds).  Lifecycle:

      * :meth:`add` — assign docs just appended to the engine to their
        nearest cells and rebuild those cells only.
      * deletes need no call — live masks re-derive from the engine.
      * :meth:`rebuild` — full re-partition with the same seed (after
        ``compact``).

    Runs on the engine's device.  ``obs`` (a
    :class:`repro_torch.obs.Observability`): each :meth:`route` records
    ``index_cells_probed``, ``index_routed_fraction`` and
    ``index_bound_pruned_total`` there, and the routed serve step its
    ``index_probe_overflow_total``.  Left out of this counterpart:
    ``cell_pad``: cells are not padded, so there is no headroom to outgrow.
    """

    def __init__(self, engine, *, num_cells: int, seed: int = 0,
                 top_p: int = 1, bound_slack: float | None = None,
                 probe_cap: int | None = None, method: str = "kcenters",
                 obs=None):
        if not hasattr(engine, "segments"):
            raise TypeError(
                "ClusterIndex needs a SegmentedEngine (per-cell segments "
                "reuse its kernels); wrap monolithic corpora in one")
        if not 1 <= num_cells <= max(1, engine.n_docs):
            raise ValueError(
                f"need 1 <= num_cells <= {engine.n_docs}, got {num_cells}")
        self.engine = engine
        self.device = engine.device
        self.num_cells = int(num_cells)
        self.seed = int(seed)
        self.top_p = int(top_p)
        self.bound_slack = bound_slack
        self.method = method
        self.obs = obs
        self.probe_cap = (int(probe_cap) if probe_cap is not None
                          else min(self.num_cells, max(8, 4 * self.top_p)))
        self.version = 0            # bumped on add/rebuild (structure changes)
        self._live_sync = None      # (engine.version, index.version) synced
        self.rebuild()

    # -- build / lifecycle -------------------------------------------------
    def _partition_labels(self) -> np.ndarray:
        """(n_docs,) int32 cell label per global doc id (deterministic)."""
        from repro_torch.workloads.clustering import kcenters, kmedoids

        if self.method == "kmedoids":
            res = kmedoids(self.engine, self.num_cells, seed=self.seed)
            return np.asarray(res.labels, dtype=np.int32)
        centers = kcenters(self.engine, self.num_cells, seed=self.seed)
        # One WCD assignment pass: the nearest center's centroid, from
        # exact differences as the reference's norm; routing uses the same
        # metric, so a query lands first on the cell its nearest docs are in.
        c_cen = self._cen[torch.from_numpy(centers.astype(np.int64))
                          .to(self.device)]
        return torch.argmin(exact_dists(self._cen, c_cen), dim=1).cpu(
        ).numpy().astype(np.int32)

    def _build_cell(self, members: np.ndarray) -> _Cell | None:
        """One cell as an unpadded EngineSegment over ``members`` (None for
        an empty cell)."""
        if not len(members):
            return None
        members = np.sort(np.asarray(members, dtype=np.int64))
        mem = torch.from_numpy(members).to(self.device)
        res = self.engine.resident
        seg = EngineSegment(DocSet(ids=res.ids[mem], weights=res.weights[mem]),
                            self.engine.emb_full, offset=0)
        return _Cell(segment=seg, members=members,
                     gids=mem.to(torch.int32))

    def rebuild(self) -> None:
        """Full deterministic re-partition (same seed): compaction's hook."""
        eng = self.engine
        self._cen = resident_centroids(eng.resident, eng.emb_full)  # (n, m)
        self._labels = self._partition_labels()
        self.cells = [self._build_cell(np.nonzero(self._labels == j)[0])
                      for j in range(self.num_cells)]
        self._n_docs_indexed = eng.n_docs
        self._bump()

    def _bump(self) -> None:
        self.version += 1
        self._live_sync = None
        self._refresh_maps()
        self._refresh_centroids()

    def _refresh_maps(self) -> None:
        """Device maps global id → cell and → row within the cell (the
        routed serve step's self-exclusion)."""
        local = np.zeros(len(self._labels), dtype=np.int32)
        for cell in self.cells:
            if cell is not None:
                local[cell.members] = np.arange(len(cell.members))
        self._labels_dev = torch.from_numpy(self._labels).to(self.device)
        self._local_dev = torch.from_numpy(local).to(self.device)

    def _refresh_centroids(self) -> None:
        """Cell means of the live members' doc centroids; radii cover every
        live member (the triangle bound's invariant)."""
        live = self.engine.live_mask()
        m_dim = self._cen.shape[1]
        mu = torch.zeros((self.num_cells, m_dim), device=self.device)
        radii = torch.zeros(self.num_cells, device=self.device)
        alive = np.zeros(self.num_cells, dtype=bool)
        n_live = np.zeros(self.num_cells, dtype=np.int64)
        for j, cell in enumerate(self.cells):
            if cell is None:
                continue
            m = cell.members[live[cell.members]]
            if not len(m):
                continue
            alive[j] = True
            n_live[j] = len(m)
            cm = self._cen[torch.from_numpy(m).to(self.device)]
            mu[j] = cm.mean(dim=0)
            radii[j] = torch.linalg.vector_norm(cm - mu[j], dim=1).amax()
        self._mu, self._radii = mu, radii
        self._alive_np = alive
        self._alive = torch.from_numpy(alive).to(self.device)
        self._cell_live = n_live

    def add(self, gids, docs: DocSet) -> np.ndarray:
        """Assign docs just appended to the engine to their nearest cells.

        ``gids`` are the global ids :meth:`SegmentedEngine.append` returned
        for ``docs`` (increasing, so each cell's members stay ascending).
        Only the touched cells are rebuilt.  Returns the cell id per doc.
        """
        gids = np.asarray(gids, dtype=np.int64).reshape(-1)
        if not len(gids):
            return np.empty(0, dtype=np.int32)
        docs = docs.to(self.device)
        h = self.engine.h_max
        if docs.h_max < h:   # as engine.append padded them
            pad = (0, h - docs.h_max)
            docs = DocSet(ids=torch.nn.functional.pad(docs.ids, pad),
                          weights=torch.nn.functional.pad(docs.weights, pad))
        cen_new = resident_centroids(docs, self.engine.emb_full)
        d = exact_dists(cen_new, self._mu)                      # (a, C)
        if self._alive_np.any():
            d = d.masked_fill(~self._alive[None, :], _INF)
        assign = torch.argmin(d, dim=1).cpu().numpy().astype(np.int32)

        self._cen = torch.cat([self._cen, cen_new])
        self._labels = np.concatenate([self._labels, assign])
        for c in np.unique(assign):
            old = (self.cells[c].members if self.cells[c] is not None
                   else np.empty(0, dtype=np.int64))
            self.cells[c] = self._build_cell(
                np.concatenate([old, gids[assign == c]]))
        self._n_docs_indexed = self.engine.n_docs
        self._bump()
        return assign

    # -- views -------------------------------------------------------------
    @property
    def rows_cap(self) -> int:
        """Row count of the largest cell.  Cells are not padded, so there
        is no headroom: an ``add`` that grows the largest cell grows this."""
        return max((c.segment.n_rows for c in self.cells if c is not None),
                   default=0)

    @property
    def labels(self) -> np.ndarray:
        """(n_docs,) int32 cell assignment per global doc id."""
        return self._labels

    @property
    def doc_centroids(self) -> torch.Tensor:
        """(n_docs, m) device WCD centroids of every indexed doc."""
        return self._cen

    @property
    def centroid_nbytes(self) -> int:
        """Device bytes of the routing state: doc centroids, cell means and
        radii, the gid tables and the id → (cell, row) maps."""
        ts = [self._cen, self._mu, self._radii, self._alive, self._labels_dev,
              self._local_dev] + [c.gids for c in self.cells if c is not None]
        return sum(t.numel() * t.element_size() for t in ts)

    @property
    def nbytes(self) -> int:
        """Device bytes the index holds: cell segments, their live masks
        and the routing state (the shared embedding table not counted)."""
        cells = sum(c.segment.nbytes + c.segment.n_rows
                    for c in self.cells if c is not None)
        return cells + self.centroid_nbytes

    def sync_live(self) -> None:
        """Re-derive the cells' live masks and means when the engine or the
        index moved; raises if the engine grew without :meth:`add`."""
        key = (self.engine.version, self.version)
        if self._live_sync == key:
            return
        if self.engine.n_docs != self._n_docs_indexed:
            raise RuntimeError(
                f"engine has {self.engine.n_docs} docs but the index covers "
                f"{self._n_docs_indexed} — docs were appended directly to "
                "the engine; call index.add(gids, docs) or index.rebuild()")
        live = self.engine.live_mask()
        self._live_dev = [
            None if c is None else
            torch.from_numpy(live[c.members]).to(self.device)
            for c in self.cells]
        self._refresh_centroids()
        self._live_sync = key

    def cell_live(self, c: int) -> torch.Tensor:
        """(n_c,) device live mask of cell ``c``'s rows (synced first)."""
        self.sync_live()
        return self._live_dev[int(c)]

    def query_rows(self, q_gid: torch.Tensor):
        """For global doc ids ``q_gid`` (B,): each one's cell (-1 for an id
        out of range) and its row in that cell, as (B,) device tensors."""
        q = q_gid.to(self.device).long()
        ok = (q >= 0) & (q < len(self._labels))
        q = q.clamp(0, len(self._labels) - 1)
        return torch.where(ok, self._labels_dev[q], -1), self._local_dev[q]

    # -- routing + routed queries -------------------------------------------
    def route(self, queries: DocSet, *, top_p: int | None = None,
              bound_slack: float | None | str = "cfg") -> RouteResult:
        """Route a query batch to cells and apply the triangle-bound stage.

        ``bound_slack="cfg"`` uses the index default; ``None`` disables the
        bound for this call.
        """
        self.sync_live()
        slack = self.bound_slack if bound_slack == "cfg" else bound_slack
        p = min(int(top_p or self.top_p), self.num_cells)
        queries = queries.to(self.device)
        c_q = centroids_from_t(queries.weights,
                               self.engine.gather_queries(queries.ids))
        d, cells, lb, ub = (x.cpu().numpy() for x in _route_cells(
            self._mu, self._radii, self._alive, c_q, p))
        cells = cells.astype(np.int32)
        keep = d < _INF              # drop empty/dead-cell slots
        n_pruned = n_docs_pruned = 0
        if slack is not None:
            bound_ok = lb <= float(slack) * ub[:, None]
            pruned = keep & ~bound_ok
            n_pruned = int(pruned.sum())
            if n_pruned:
                n_docs_pruned = int(self._cell_live[cells[pruned]].sum())
            keep &= bound_ok
        probed = (np.unique(cells[keep]) if keep.any()
                  else np.empty(0, dtype=np.int64)).astype(np.int64)
        self._record_route_obs(probed, n_pruned)
        return RouteResult(cells=cells, keep=keep, probed=probed,
                           n_bound_pruned=n_pruned,
                           n_docs_pruned=n_docs_pruned)

    def _record_route_obs(self, probed: np.ndarray,
                          n_bound_pruned: int) -> None:
        obs = self.obs
        if obs is None or not obs.metrics.enabled:
            return
        from repro_torch.obs import COUNT_BUCKETS

        m = obs.metrics
        m.histogram("index_cells_probed",
                    "Distinct cells probed per routed batch.",
                    buckets=COUNT_BUCKETS).observe(len(probed))
        rows = [0 if c is None else c.segment.n_rows for c in self.cells]
        m.gauge("index_routed_fraction",
                "Fraction of resident cell rows the last routed batch "
                "scanned.").set(
            sum(rows[int(c)] for c in probed) / max(1, sum(rows)))
        if n_bound_pruned:
            m.counter("index_bound_pruned_total",
                      "(query, cell) routing slots pruned by the "
                      "centroid/triangle bound stage.").inc(n_bound_pruned)

    def fold_cells(self, queries: DocSet, k: int, probed, cells: np.ndarray,
                   keep: np.ndarray, *, symmetric: bool,
                   q_gid: torch.Tensor | None = None,
                   bf16_matmul: bool | None = None) -> TopK:
        """Streaming top-k over the ``probed`` cells, each on the queries
        whose kept slots (``cells`` / ``keep``, (B, p)) name it: TopK
        (B, min(k, Σ cell widths)), global ids, ascending.

        A cell runs phase 1 over its own vocabulary and the fused top-k
        with its live mask (``symmetric``: the d21 mode too) on its routed
        queries only; a query not routed to a cell gets (+inf, -1) from
        it, and so does an unfilled slot.  ``q_gid`` (B,) global ids to
        self-exclude: each cell gets the query's row in it, -1 where the
        query's doc is not a member.
        """
        self.sync_live()
        eng = self.engine
        queries = queries.to(self.device)
        bf16 = eng.bf16_matmul if bf16_matmul is None else bf16_matmul
        b, h = queries.ids.shape
        t_q = eng.gather_queries(queries.ids)                  # (B, h, m)
        local = None if q_gid is None else self.query_rows(q_gid)
        parts = []
        for c in np.asarray(probed, dtype=np.int64):
            cell = self.cells[int(c)]
            if cell is None:
                continue
            qmask = ((cells == c) & keep).any(axis=1)
            if not qmask.any():
                continue
            every = bool(qmask.all())
            sel = (slice(None) if every else
                   torch.from_numpy(np.nonzero(qmask)[0]).to(self.device))
            cq_gid = None
            if local is not None:
                cq_gid = torch.where(local[0] == int(c), local[1],
                                     -1).to(torch.int32)[sel]
            q_ids, q_w, tq = queries.ids[sel], queries.weights[sel], t_q[sel]
            tk = _segment_topk(
                cell.segment.tensors, tq.reshape(-1, tq.shape[-1]), q_ids,
                q_w, k=min(k, cell.segment.n_rows), symmetric=symmetric,
                row_block=max(1, min(eng.row_block, cell.segment.n_rows)),
                bf16_matmul=bf16, vocab_chunk=eng.vocab_chunk,
                row_valid=self._live_dev[int(c)], q_gid=cq_gid)
            filled = tk.indices >= 0
            g = torch.where(filled, cell.gids[tk.indices.clamp(min=0).long()],
                            -1)
            d = torch.where(filled, tk.dists, _INF)
            if not every:
                full_d = torch.full((b, d.shape[1]), _INF, device=self.device)
                full_i = torch.full((b, d.shape[1]), -1, dtype=torch.int32,
                                    device=self.device)
                full_d[sel], full_i[sel] = d, g
                d, g = full_d, full_i
            parts.append(TopK(d, g))
        if not parts:
            return TopK(torch.full((b, 0), _INF, device=self.device),
                        torch.full((b, 0), -1, dtype=torch.int32,
                                   device=self.device))
        width = sum(p.dists.shape[1] for p in parts)
        return merge_topk(parts, min(k, width))

    def routed_topk(self, queries: DocSet, k: int, *,
                    top_p: int | None = None,
                    bound_slack: float | None | str = "cfg",
                    route: RouteResult | None = None) -> TopK:
        """Streaming symmetric top-k over the routed cells only: TopK
        (B, min(k, n_docs)), padded with (+inf, -1) where fewer routed rows
        than that exist.

        With ``top_p = num_cells`` and the bound off this equals
        ``engine.topk(queries, k)`` bit for bit: the same fold, the same
        lexicographic tie order, global ids through each cell's table.
        """
        if route is None:
            route = self.route(queries, top_p=top_p, bound_slack=bound_slack)
        k_out = min(k, max(self.engine.n_docs, 1))
        tk = self.fold_cells(queries, k_out, route.probed, route.cells,
                             route.keep, symmetric=True)
        return pad_topk(tk, k_out)
