"""The LC-RWMD serve step on one device (counterpart of
``repro.distributed.lcrwmd_dist``).

The reference builds its serve step as a ``shard_map`` program over a
``(pod, data, model)`` mesh: resident rows over the batch axes, the
vocabulary over ``model``, the query batch replicated.  With the mesh
collapsed to one device every collective is the identity, and what is left
is the per-shard program, run here on the port's kernels:

  * phase 1 (Z over the restricted, or for the engine-less step the full,
    vocabulary) is the phase-1 kernel;
  * the streaming step is the fused phase-2 top-k kernel, with the
    tombstone mask (``row_valid``) and self-exclusion (``q_gid``) applied
    inside it; ``streaming=False``, the engine-less step and
    :func:`build_allpairs_d1` materialize D with the ELL SpMM kernel;
  * the WMD rerank is the Sinkhorn-WMD kernel
    (``wmd_candidate_values(use_kernel=True)``, where the reference's
    engine-less rerank runs its batched jnp solver);
  * the symmetric refine is ``core/rwmd.rwmd_pairs_from_t`` on the (B, kc)
    candidate pairs, as the reference computes it in jnp outside any
    kernel; tier 2 is the Word Centroid Distance from resident centroids.

On CPU tensors each kernel's plain version runs.  Kept from the reference:
``ServeResult``; the tiers (0 the full cascade, 1 the LC-RWMD candidates,
2 the WCD shortlist); ``pruned_exact``; ``self_exclude`` with
``query_ids``; the clamping of ``rerank_budget``; the defaults
(``bf16_matmul=True``).  A :class:`~repro_torch.core.lc_rwmd.SegmentedEngine`
step re-reads its state when ``engine.version`` changes, and only then.

With ``index=`` (a :class:`~repro_torch.index.ClusterIndex`) the step is
routed: each probed cell runs phase 1 over its own vocabulary and the
fused top-k with its live mask on the queries routed to it only.  The
reference stacks its cells into one padded tensor and runs every query
against every probe slot, for one static jit shape; the results of the
routed (query, cell) pairs are the same.

``obs=`` (a :class:`repro_torch.obs.Observability`) records the host time
of each engine step's call as ``serve_step_host_seconds{variant=mono|seg|
routed}``: on the card the kernels are queued when the call returns, so
this is launch cost, not device time.  The routed step counts dropped
probe cells in ``index_probe_overflow_total`` of its index's ``obs``.

Left out: ``mesh``, ``phase1_full_mesh`` and ``psum_batch`` (the
multi-device program, and the slab batching of its collectives) and with
them the ``serve_step_collectives_*`` gauges; the reference's module-level
step cache and its re-trace sentinel (eager PyTorch traces nothing, so
there is nothing to cache or re-trace; the port's cold start is a kernel
library load, which :mod:`repro_torch.obs.sentinel` watches).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as topk_lib
from repro_torch.core.distances import dists
from repro_torch.core.lc_rwmd import (
    LCRWMDEngine,
    SegmentedEngine,
    _segment_dense,
    _segment_topk,
    as_f32,
    doc_targets,
    lc_rwmd_one_sided,
)
from repro_torch.core.rwmd import rwmd_pairs_from_t
from repro_torch.core.wcd import centroids_from_t, resident_centroids
from repro_torch.core.wmd import wmd_candidate_values
from repro_torch.data.docs import DocSet
from repro_torch.device import resolve_device
from repro_torch.index.cluster_index import pad_topk

TopK = topk_lib.TopK
_INF = 3.4e38       # the reference's mask value in the serve step
_DEAD_CENTROID = 1e18  # a tombstoned doc's centroid: out of any shortlist


class ServeResult(NamedTuple):
    topk: TopK                   # (B, k): global doc ids + distances
    d_local: torch.Tensor | None  # (n, B) distances (None when streaming)
    pruned_exact: torch.Tensor | None = None  # (B,) bool, rerank path: True
    #                              → the WMD top-k provably equals the
    #                              full-corpus WMD top-k
    tier: int = 0                # the QualityTier the batch was served at


def build_serve_step(*, k: int, refine: bool = False, bf16_matmul: bool = True,
                     engine=None, rerank_wmd: bool = False,
                     rerank_budget: int | None = None,
                     wmd_kw: dict | None = None, self_exclude: bool = False,
                     streaming: bool | None = None, row_block: int = 128,
                     device=None, index=None, obs=None):
    """Returns ``serve(resident, queries, emb) -> ServeResult``, or with an
    ``engine`` ``serve(queries, query_ids=None, *, tier=0)``.

    ``engine``: an :class:`LCRWMDEngine` or a :class:`SegmentedEngine`; the
    step runs on the engine's device (``device``, if given, must be the
    same).  Without one, the step runs on ``device`` (``None`` → ``"cuda"``,
    which raises without a card) and takes the resident set each call: the
    paper-faithful materialized path (no ``streaming``, no
    ``self_exclude``).

    ``refine=True`` tightens the (B, kc) one-sided candidates with the
    symmetric bound evaluated only on those pairs, then re-sorts them.
    ``rerank_wmd=True`` reranks the top-``rerank_budget`` candidates (default
    2k, at least k, at most the corpus) by batched Sinkhorn-WMD (``wmd_kw``
    forwarded) down to k, and sets ``pruned_exact``.  ``self_exclude=True``
    (engine path): ``serve(queries, query_ids)`` with each query's global
    doc id, whose own row is +inf.  ``streaming`` (engine path, default
    True): the fused top-k, never an (n, B) matrix; ``False`` materializes D
    and returns it as ``d_local`` (monolithic engine only).
    ``row_block`` is the plain fold's slab height on CPU.

    Tiers (``serve(..., tier=)``): 0 the full configured cascade, 1 the
    LC-RWMD candidates (refine and rerank shed), 2 the WCD shortlist.

    ``index``: a :class:`~repro_torch.index.ClusterIndex` over ``engine``
    (a :class:`SegmentedEngine`).  Tiers 0 and 1 then route each batch:
    ``index.route`` picks each query's cells (top-p, triangle bound), the
    batch's probed union is capped at ``index.probe_cap`` cells (overflow
    drops the least-requested cells), and only those cells are scanned,
    each on its routed queries.  Tier 2 stays unrouted.  The step raises
    if the engine grew without ``index.add``.

    ``obs``: the bundle that ``serve_step_host_seconds`` goes to (engine
    steps only).
    """
    kc = max((rerank_budget or 2 * k) if rerank_wmd else k, k)
    if engine is not None:
        if device is not None and resolve_device(device) != engine.device:
            raise ValueError(f"device {device} is not the engine's "
                             f"({engine.device})")
        kc = min(kc, engine.n_docs if isinstance(engine, SegmentedEngine)
                 else engine.resident.n_docs)
    if index is not None:
        if not isinstance(engine, SegmentedEngine):
            raise ValueError(
                "a ClusterIndex serve step needs a SegmentedEngine "
                "(the index's cells are engine segments)")
        if streaming is False:
            raise ValueError(
                "the routed serve step is streaming-only (d_local "
                "diagnostics are a monolithic-engine feature)")
        return _timed(obs, "routed", _routed_serve_step(
            engine, index, k=k, kc=kc, refine=refine,
            bf16_matmul=bf16_matmul, rerank_wmd=rerank_wmd, wmd_kw=wmd_kw,
            self_exclude=self_exclude))
    if isinstance(engine, SegmentedEngine):
        if streaming is False:
            raise ValueError(
                "the segmented serve step is streaming-only (d_local "
                "diagnostics are a monolithic-engine feature)")
        return _timed(obs, "seg", _segmented_serve_step(
            engine, k=k, kc=kc, refine=refine, bf16_matmul=bf16_matmul,
            rerank_wmd=rerank_wmd, wmd_kw=wmd_kw, self_exclude=self_exclude))
    if engine is not None:
        return _timed(obs, "mono", _engine_serve_step(
            engine, k=k, kc=kc, refine=refine, bf16_matmul=bf16_matmul,
            rerank_wmd=rerank_wmd, wmd_kw=wmd_kw, self_exclude=self_exclude,
            streaming=True if streaming is None else streaming,
            row_block=row_block))
    if self_exclude:
        raise ValueError("self_exclude requires an engine-backed serve step")
    if streaming:
        raise ValueError("streaming top-k requires an engine-backed serve step")
    dev = resolve_device(device)

    def serve(resident: DocSet, queries: DocSet, emb) -> ServeResult:
        resident, queries = resident.to(dev), queries.to(dev)
        emb = as_f32(emb, dev)
        d_local = lc_rwmd_one_sided(resident, queries, emb,
                                    bf16_matmul=bf16_matmul)       # (n, B)
        tk = topk_lib.topk_smallest_cols(d_local, min(kc, resident.n_docs))
        if refine:
            tk = _symmetric_refine(resident, queries, emb, tk)
        if rerank_wmd:
            tk = _wmd_rerank(resident, queries, emb, tk, k, wmd_kw)
        return ServeResult(topk=tk, d_local=d_local)

    return serve


def _timed(obs, variant: str, serve):
    """``serve`` with its host wall time observed per call into ``obs``'s
    ``serve_step_host_seconds{variant=...}`` (``serve`` itself without an
    ``obs``)."""
    if obs is None:
        return serve
    hist = obs.metrics.histogram(
        "serve_step_host_seconds",
        "Host wall time of one serve-step call (the kernels are queued on "
        "the stream when it returns; device time lands in device_compute "
        "spans).", labels={"variant": variant})

    def timed(queries: DocSet, query_ids=None, *, tier: int = 0):
        t0 = time.perf_counter()
        out = serve(queries, query_ids, tier=tier)
        hist.observe(time.perf_counter() - t0)
        return out

    return timed


def _query_gids(self_exclude: bool, queries: DocSet, query_ids,
                dev: torch.device) -> torch.Tensor | None:
    """(B,) int32 device ids to self-exclude, or None."""
    if not self_exclude:
        return None
    if query_ids is None:
        raise ValueError("self_exclude serve step needs query_ids (B,)")
    q_gid = torch.as_tensor(query_ids, dtype=torch.int32, device=dev)
    if tuple(q_gid.shape) != (queries.n_docs,):
        raise ValueError(f"query_ids must have shape ({queries.n_docs},), "
                         f"got {tuple(q_gid.shape)}")
    return q_gid


def _finish(engine, queries: DocSet, tk: TopK, *, k: int, kc: int,
            n_cover: int, tier: int, refine: bool, rerank_wmd: bool,
            wmd_kw: dict | None, d_local=None,
            covered: bool = True) -> ServeResult:
    """Tiers 0 and 1 after the candidate step: tier 1 serves the first k
    candidates; tier 0 refines and reranks as configured.  ``n_cover``:
    candidates at least this many cover every live doc (always exact),
    when ``covered`` (the routed step: routing kept every cell for every
    query)."""
    if tier >= 1:
        return ServeResult(topk=TopK(tk.dists[:, :k], tk.indices[:, :k]),
                           d_local=d_local, tier=tier)
    # Largest candidate RWMD: every non-candidate's WMD is >= this, so it
    # certifies the rerank against the k-th WMD cutoff below.
    cand_max_rwmd = tk.dists[:, -1]
    exact = None
    if refine:
        tk = _symmetric_refine(engine.resident, queries, engine.emb_full, tk)
    if rerank_wmd:
        tk = engine.rerank_topk(queries, tk.indices, k, sinkhorn_kw=wmd_kw)
        exact = cand_max_rwmd >= tk.dists[:, -1]
        if kc >= n_cover and covered:
            exact = torch.ones_like(exact)
    return ServeResult(topk=tk, d_local=d_local, pruned_exact=exact)


def _engine_serve_step(engine: LCRWMDEngine, *, k, kc, refine, bf16_matmul,
                       rerank_wmd, wmd_kw, self_exclude, streaming,
                       row_block):
    """Serve step over a monolithic :class:`LCRWMDEngine`.

    Phase 1 runs against the engine's restricted vocabulary, the queries'
    embeddings gathered from the full table (so out-of-resident-vocabulary
    query words stay exact).  Tier 2's centroids are made at the first
    tier-2 call.
    """
    dev = engine.device
    seg = engine._segment_tensors()
    n_real = engine.resident.n_docs
    state: dict = {}

    def serve(queries: DocSet, query_ids=None, *, tier: int = 0) -> ServeResult:
        tier = int(tier)
        queries = queries.to(dev)
        q_gid = _query_gids(self_exclude, queries, query_ids, dev)
        if tier >= 2:   # QualityTier.WCD
            if "cent" not in state:
                state["cent"] = resident_centroids(engine.resident,
                                                   engine.emb_full)
            return ServeResult(
                topk=_wcd_topk(k, state["cent"], engine, queries, q_gid),
                d_local=None, tier=tier)
        t_q = engine._gather_flat(queries.ids)
        d_local = None
        if streaming:
            tk = _segment_topk(seg, t_q, queries.ids, queries.weights, k=kc,
                               symmetric=False, row_block=row_block,
                               bf16_matmul=bf16_matmul, q_gid=q_gid)
        else:
            d_local = _segment_dense(seg, t_q, queries.ids, queries.weights,
                                     symmetric=False,
                                     bf16_matmul=bf16_matmul)      # (n, B)
            if q_gid is not None:
                rows = torch.arange(n_real, dtype=torch.int32, device=dev)
                d_local = d_local.masked_fill(rows[:, None] == q_gid[None, :],
                                              _INF)
            tk = topk_lib.topk_smallest_cols(d_local, kc)
        return _finish(engine, queries, tk, k=k, kc=kc, n_cover=n_real,
                       tier=tier, refine=refine, rerank_wmd=rerank_wmd,
                       wmd_kw=wmd_kw, d_local=d_local)

    return serve


def _segmented_serve_step(engine: SegmentedEngine, *, k, kc, refine,
                          bf16_matmul, rerank_wmd, wmd_kw, self_exclude):
    """Serve step over a :class:`SegmentedEngine`.

    Each segment phase-1s against its own restricted vocabulary and runs
    the fused top-k with its tombstone mask and, under ``self_exclude``,
    the query ids shifted by its offset; the (distance, global id)
    candidates merge into one (B, kc) top-k.  The engine's device masks are
    copied once per corpus version, and tier 2's centroids (tombstoned rows
    out of reach) are remade at the first tier-2 call of a new version, so
    the SAME callable keeps serving across append, delete and compact.
    """
    dev = engine.device
    state: dict = {"version": None}

    def serve(queries: DocSet, query_ids=None, *, tier: int = 0) -> ServeResult:
        tier = int(tier)
        if not engine.segments:
            raise ValueError("segmented serve step needs a non-empty engine")
        if state["version"] != engine.version:
            state.clear()
            state["version"] = engine.version
        queries = queries.to(dev)
        q_gid = _query_gids(self_exclude, queries, query_ids, dev)
        if tier >= 2:   # QualityTier.WCD
            if "cent" not in state:
                cent = resident_centroids(engine.resident, engine.emb_full)
                state["cent"] = cent.masked_fill(
                    ~engine.live_mask_device()[:, None], _DEAD_CENTROID)
            return ServeResult(
                topk=_wcd_topk(k, state["cent"], engine, queries, q_gid),
                d_local=None, tier=tier)
        tk = engine.fold_topk(queries, kc, symmetric=False, q_gid=q_gid,
                              bf16_matmul=bf16_matmul)
        return _finish(engine, queries, tk, k=k, kc=kc, n_cover=engine.n_live,
                       tier=tier, refine=refine, rerank_wmd=rerank_wmd,
                       wmd_kw=wmd_kw)

    return serve


def _routed_serve_step(engine: SegmentedEngine, index, *, k, kc, refine,
                       bf16_matmul, rerank_wmd, wmd_kw, self_exclude):
    """Serve step routed through a :class:`~repro_torch.index.ClusterIndex`.

    Per batch: ``index.route`` picks each query's cells, the batch's
    probed union is capped at ``index.probe_cap`` cells, and each probed
    cell runs phase 1 over its own vocabulary and the one-sided fused top-k
    with its live mask (under ``self_exclude``, each query's row in that
    cell) on the queries routed to it; the (distance, global id)
    candidates merge into (B, kc), empty slots at (3.4e38, -1).  The
    index's live masks and the tier-2 centroids (the index's doc
    centroids, tombstoned rows out of reach) are re-read when
    ``engine.version`` or ``index.version`` moves, and only then.  ``pruned_exact`` is relative to the routed cells, and
    unconditional only when routing kept every cell for every query.
    """
    dev = engine.device
    p_max = index.probe_cap
    state: dict = {"key": None}

    def refresh():
        index._sync_live()   # raises if the engine grew without index.add
        key = (engine.version, index.version)
        if state["key"] == key:
            return
        rows_cap = index.rows_cap
        if p_max * rows_cap < k:
            raise ValueError(
                f"probe_cap={p_max} × largest cell {rows_cap} rows cannot "
                f"yield k={k} candidates; raise probe_cap or num_cells")
        state.clear()
        state["key"] = key
        state["kc"] = min(kc, p_max * rows_cap)

    def pack(route):
        """The probed union capped at ``p_max`` cells: (probed, keep)."""
        probed, keep = route.probed, route.keep
        if len(probed) > p_max:
            # Overflow: keep the cells the most queries asked for.
            req = np.zeros(index.num_cells, dtype=np.int64)
            np.add.at(req, route.cells[keep].reshape(-1), 1)
            order = np.argsort(-req[probed], kind="stable")
            dropped = probed[order[p_max:]]
            probed = np.sort(probed[order[:p_max]])
            keep = keep & ~np.isin(route.cells, dropped)
            if index.obs is not None and index.obs.metrics.enabled:
                index.obs.metrics.counter(
                    "index_probe_overflow_total",
                    "Probed cells dropped because a batch's routed-cell "
                    "union exceeded probe_cap slots.").inc(len(dropped))
        return probed, keep

    def serve(queries: DocSet, query_ids=None, *, tier: int = 0) -> ServeResult:
        tier = int(tier)
        refresh()
        queries = queries.to(dev)
        q_gid = _query_gids(self_exclude, queries, query_ids, dev)
        if tier >= 2:   # QualityTier.WCD: no routing on the last rung
            if "cent" not in state:
                state["cent"] = index.doc_centroids.masked_fill(
                    ~engine.live_mask_device()[:, None], _DEAD_CENTROID)
            return ServeResult(
                topk=_wcd_topk(k, state["cent"], engine, queries, q_gid),
                d_local=None, tier=tier)
        route = index.route(queries)
        probed, keep = pack(route)
        kcs = state["kc"]
        tk = pad_topk(index.fold_cells(
            queries, kcs, probed, route.cells, keep, symmetric=False,
            q_gid=q_gid, bf16_matmul=bf16_matmul), kcs)
        # An empty slot carries the step's mask value, as in the reference:
        # a query left with fewer than k candidates is then not certified.
        tk = TopK(tk.dists.masked_fill(tk.indices < 0, _INF), tk.indices)
        covered = bool(keep.all()) and route.cells.shape[1] == index.num_cells
        return _finish(engine, queries, tk, k=k, kc=kcs,
                       n_cover=engine.n_live, tier=tier, refine=refine,
                       rerank_wmd=rerank_wmd, wmd_kw=wmd_kw, covered=covered)

    return serve


def _symmetric_refine(resident: DocSet, queries: DocSet, emb: torch.Tensor,
                      tk: TopK) -> TopK:
    """Tighten (B, kc) one-sided candidates with the symmetric RWMD of each
    (candidate, query) pair, max(D1, RWMD), then sort each row by it
    (stable: equal values keep their candidate order, as ``jnp.argsort``).

    An unfilled slot (id -1) keeps its distance, which already ranks last.
    """
    b, kc = tk.indices.shape
    t1, w1 = doc_targets(resident, emb,
                         tk.indices.reshape(-1).clamp(0, resident.n_docs - 1))
    t2 = emb.index_select(0, queries.ids.to(emb.device).reshape(-1)).reshape(
        b, queries.h_max, -1)
    d_sym = rwmd_pairs_from_t(
        t1, w1, t2.repeat_interleave(kc, dim=0),
        queries.weights.repeat_interleave(kc, dim=0)).reshape(b, kc)
    d = torch.where(tk.indices >= 0, torch.maximum(tk.dists, d_sym), tk.dists)
    order = torch.sort(d, dim=-1, stable=True).indices
    return TopK(torch.gather(d, -1, order), torch.gather(tk.indices, -1, order))


def _wmd_rerank(resident: DocSet, queries: DocSet, emb: torch.Tensor, tk: TopK,
                k: int, wmd_kw: dict | None) -> TopK:
    """Engine-less rerank: (B, budget) candidates by batched Sinkhorn-WMD (the
    kernel on CUDA), keep the top k."""
    t1, w1 = doc_targets(resident, emb, tk.indices.reshape(-1))
    t_q = emb.index_select(0, queries.ids.reshape(-1)).reshape(
        *queries.ids.shape, -1)
    vals = wmd_candidate_values(t1, w1, t_q, queries.weights, use_kernel=True,
                                **(wmd_kw or {}))
    return topk_lib.topk_from_candidates(vals, tk.indices, k)


def _wcd_topk(k: int, cent: torch.Tensor, engine, queries: DocSet,
              q_gid: torch.Tensor | None) -> TopK:
    """Tier 2: top-k by Word Centroid Distance only (no phase 1 or 2)."""
    c_q = centroids_from_t(queries.weights, engine.gather_queries(queries.ids))
    d = dists(cent, c_q)                                         # (n, B)
    if q_gid is not None:
        rows = torch.arange(cent.shape[0], dtype=torch.int32, device=d.device)
        d = d.masked_fill(rows[:, None] == q_gid[None, :], _INF)
    return topk_lib.topk_smallest_cols(d, k)


def build_allpairs_d1(*, bf16_matmul: bool = True, device=None):
    """All-pairs one-sided LC-RWMD: ``d1(set1, set2, emb)`` → D1 (n1, n2).

    The symmetric all-pairs bound runs it twice with the sets swapped and
    takes max(D1, D2ᵀ) (paper Sec. IV); n2 plays the role of a query batch
    and callers chunk it.  Phase 1 and the ELL SpMM are the kernels on
    ``device`` (``None`` → ``"cuda"``).
    """
    dev = resolve_device(device)

    def d1(set1: DocSet, set2: DocSet, emb) -> torch.Tensor:
        return lc_rwmd_one_sided(set1.to(dev), set2.to(dev), as_f32(emb, dev),
                                 bf16_matmul=bf16_matmul)

    return d1
