"""The LC-RWMD serve step (counterpart of ``repro.distributed.lcrwmd_dist``).

The reference builds its serve step as a ``shard_map`` program over a
``(pod, data, model)`` mesh.  Without a mesh (``mesh=None``) the step runs
on one device; with one (:mod:`repro_torch.launch.mesh`, on
``torch.distributed``) every rank runs its shard of the program on its own
device, with the reference's sharding and collective schedule:

  resident docs (ids, weights)  -> rows over (pod, data), row-major, in
                                   contiguous blocks
  embedding rows (vocabulary)   -> over model, or with ``phase1_full_mesh``
                                   over (model, *batch axes), model-major
  query batch                   -> replicated

  1. query embeddings: a masked gather of the rank's rows + psum over
     model (and the batch axes under a full mesh); the engine steps gather
     them from the full table on every rank instead, as the reference does
     outside its kernel;
  2. phase 1 on the rank's vocabulary rows; under a full mesh the Z slices
     are all-gathered over the batch axes (in reverse order) into the
     model span's Z;
  3. the phase-2 partial on the rank's rows against that span (ids outside
     it weigh 0), then psum over model;
  4. the top-k: the rank's (B, kc) candidates all-gathered over the batch
     axes.

Each shard runs on the port's kernels:

  * phase 1 is the phase-1 kernel;
  * the streaming step is the fused phase-2 top-k kernel, with the
    tombstone mask (``row_valid``) and self-exclusion (``q_gid``) applied
    inside it; under a mesh with ``model`` > 1 a partial D still needs its
    sum, so the streaming step runs the ELL SpMM kernel slab by slab
    (``psum_batch`` · ``row_block`` rows a psum) and folds each summed slab
    into a :class:`~repro_torch.core.topk.StreamingTopK` carry;
    ``streaming=False``, the engine-less step and :func:`build_allpairs_d1`
    materialize D with the ELL SpMM kernel;
  * the WMD rerank is the Sinkhorn-WMD kernel
    (``wmd_candidate_values(use_kernel=True)``, where the reference's
    engine-less rerank runs its batched jnp solver);
  * the symmetric refine is ``core/rwmd.rwmd_pairs_from_t`` on the (B, kc)
    candidate pairs, as the reference computes it in jnp outside any
    kernel; tier 2 is the Word Centroid Distance from resident centroids.
    Both run replicated on every rank, after the top-k.

On CPU tensors each kernel's plain version runs.  Kept from the reference:
``ServeResult``; the tiers (0 the full cascade, 1 the LC-RWMD candidates,
2 the WCD shortlist); ``pruned_exact``; ``self_exclude`` with
``query_ids``; the clamping of ``rerank_budget``; the defaults
(``bf16_matmul=True``, ``phase1_full_mesh=True``, ``psum_batch=8``).  A
:class:`~repro_torch.core.lc_rwmd.SegmentedEngine` step re-reads its state
when ``engine.version`` changes, and only then.

Under a mesh a :class:`~repro_torch.core.lc_rwmd.SegmentedEngine` step cuts
each segment as the monolithic step cuts the engine (its rows over the
batch axes, its restricted table over model or the whole mesh) and folds
every segment's candidates, with its live mask and its offset, into one
carry before one cross-rank top-k; a routed step cuts each cell so and
folds each probed cell on its routed queries.  Every rank holds the
whole engine and index and runs the same host work (versions, routing,
packing), so every rank issues the same collectives in the same order; a
rank with no row of a segment or cell still runs its phase 1 and joins
its gathers and psums.  Any mesh, one of one rank included, runs this
program.

With ``index=`` (a :class:`~repro_torch.index.ClusterIndex`) the step is
routed: each probed cell runs phase 1 over its own vocabulary and the
fused top-k with its live mask on the queries routed to it only.  The
reference stacks its cells into one padded tensor and runs every query
against every probe slot, for one static jit shape; the results of the
routed (query, cell) pairs are the same.

``obs=`` (a :class:`repro_torch.obs.Observability`) records the host time
of each engine step's call as ``serve_step_host_seconds{variant=mono|seg|
routed}``: on the card the kernels are queued when the call returns, so
this is launch cost, not device time.  Under a mesh, the first tier-0 or
tier-1 call of an engine step also sets ``serve_step_collectives_psum``
and ``serve_step_collectives_all_gather`` ``{variant=mono|seg|routed}``
to the collectives the mesh issued in that call.  The reference counts
its jaxpr's collectives, those over axes of size 1 included (and one psum
a slab even where ``model`` = 1); the port counts what it issues: none
over an axis of size 1.  The routed step counts
dropped probe cells in ``index_probe_overflow_total`` of its index's
``obs``.

Unlike the reference, which returns one global (n, B) array sharded over
rows, a mesh step's ``d_local`` and :func:`build_allpairs_d1`'s result are
this rank's own row block, rows :func:`local_rows` of the resident set;
the ranks of one (pod, data) block hold the same rows.

Left out: the reference's module-level step cache and its re-trace
sentinel (eager PyTorch traces nothing, so there is nothing to cache or
re-trace; the port's cold start is a kernel library load, which
:mod:`repro_torch.obs.sentinel` watches).
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
    SegmentTensors,
    _offset_topk,
    _phase1_from_t,
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
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MODEL_AXIS, batch_axes

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


def build_serve_step(mesh=None, *, k: int, refine: bool = False,
                     bf16_matmul: bool = True, phase1_full_mesh: bool = True,
                     engine=None, rerank_wmd: bool = False,
                     rerank_budget: int | None = None,
                     wmd_kw: dict | None = None, self_exclude: bool = False,
                     streaming: bool | None = None, row_block: int = 128,
                     psum_batch: int = 8, device=None, index=None, obs=None):
    """Returns ``serve(resident, queries, emb) -> ServeResult``, or with an
    ``engine`` ``serve(queries, query_ids=None, *, tier=0)``.

    ``mesh``: a :class:`repro_torch.launch.mesh.Mesh`, or ``None`` for one
    device.  Under a mesh every rank calls the step with the same
    arguments; ``ServeResult.topk`` is then the same on every rank, and
    ``d_local`` is this rank's row block (rows ``local_rows(mesh, n)``).
    ``phase1_full_mesh`` shards the vocabulary over the whole mesh (each
    rank's phase 1 scans v / ranks rows, then the Z slices are gathered
    over the batch axes), ``False`` over ``model`` alone (the paper's
    mapping: the ranks of a model line repeat one phase 1).
    ``psum_batch``: under a mesh with ``model`` > 1, the streaming step
    sums ``psum_batch`` slabs of ``row_block`` rows with one psum; it
    changes the number of collectives, never the result.  The segmented
    and routed steps run the mesh program under any mesh (one of one rank
    included); between calls every rank makes the same corpus changes.

    ``engine``: an :class:`LCRWMDEngine` or a :class:`SegmentedEngine`; the
    step runs on the engine's device (``device``, and a mesh's device, if
    given, must be the same).  Without one, the step runs on ``device``
    (``None`` → the mesh's device, else ``"cuda"``, which raises without a
    card) and takes the resident set each call: the paper-faithful
    materialized path (no ``streaming``, no ``self_exclude``).

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
    steps only), and under a mesh each engine step's
    ``serve_step_collectives_*`` gauges (its first tier-0 or tier-1 call).
    """
    kc = max((rerank_budget or 2 * k) if rerank_wmd else k, k)
    if engine is not None:
        if device is not None and resolve_device(device) != engine.device:
            raise ValueError(f"device {device} is not the engine's "
                             f"({engine.device})")
        if mesh is not None and not _same_device(mesh.device, engine.device):
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"engine's ({engine.device})")
        kc = min(kc, engine.n_docs if isinstance(engine, SegmentedEngine)
                 else engine.resident.n_docs)
    cascade = dict(k=k, kc=kc, refine=refine, rerank_wmd=rerank_wmd,
                   wmd_kw=wmd_kw, self_exclude=self_exclude)
    shard_kw = dict(bf16_matmul=bf16_matmul, full_mesh=phase1_full_mesh,
                    row_block=row_block, psum_batch=psum_batch)
    if index is not None:
        if not isinstance(engine, SegmentedEngine):
            raise ValueError(
                "a ClusterIndex serve step needs a SegmentedEngine "
                "(the index's cells are engine segments)")
        if streaming is False:
            raise ValueError(
                "the routed serve step is streaming-only (d_local "
                "diagnostics are a monolithic-engine feature)")
        if mesh is None:
            def fold(queries, kcs, probed, cells, keep, q_gid):
                return index.fold_cells(queries, kcs, probed, cells, keep,
                                        symmetric=False, q_gid=q_gid,
                                        bf16_matmul=bf16_matmul)
        else:
            fold = _mesh_cell_fold(mesh, engine, index, **shard_kw)
        return _timed(obs, "routed", _collectives(
            obs, "routed", mesh, _routed_serve_step(engine, index, fold=fold,
                                                    **cascade)))
    if isinstance(engine, SegmentedEngine):
        if streaming is False:
            raise ValueError(
                "the segmented serve step is streaming-only (d_local "
                "diagnostics are a monolithic-engine feature)")
        if mesh is None:
            def fold(queries, q_gid):
                return engine.fold_topk(queries, kc, symmetric=False,
                                        q_gid=q_gid, bf16_matmul=bf16_matmul)
        else:
            fold = _mesh_segment_fold(mesh, engine, kc=kc, **shard_kw)
        return _timed(obs, "seg", _collectives(
            obs, "seg", mesh, _segmented_serve_step(engine, fold=fold,
                                                    **cascade)))
    if engine is not None:
        streaming = True if streaming is None else streaming
        if mesh is not None:
            return _timed(obs, "mono", _collectives(
                obs, "mono", mesh, _mesh_engine_serve_step(
                    mesh, engine, streaming=streaming, **cascade,
                    **shard_kw)))
        return _timed(obs, "mono", _engine_serve_step(
            engine, k=k, kc=kc, refine=refine, bf16_matmul=bf16_matmul,
            rerank_wmd=rerank_wmd, wmd_kw=wmd_kw, self_exclude=self_exclude,
            streaming=streaming, row_block=row_block))
    if self_exclude:
        raise ValueError("self_exclude requires an engine-backed serve step")
    if streaming:
        raise ValueError("streaming top-k requires an engine-backed serve step")
    dev = _step_device(mesh, device)

    def serve(resident: DocSet, queries: DocSet, emb) -> ServeResult:
        resident, queries = resident.to(dev), queries.to(dev)
        emb = as_f32(emb, dev)
        if mesh is None:
            d_local = lc_rwmd_one_sided(resident, queries, emb,
                                        bf16_matmul=bf16_matmul)   # (n, B)
            tk = topk_lib.topk_smallest_cols(d_local,
                                             min(kc, resident.n_docs))
        else:
            d_local, (lo, _) = _mesh_one_sided(
                mesh, resident, queries, emb, bf16_matmul=bf16_matmul,
                full_mesh=phase1_full_mesh)                 # (n_local, B)
            tk = topk_lib.distributed_topk(
                d_local, min(kc, resident.n_docs), mesh=mesh,
                axis_names=batch_axes(mesh), shard_offset=lo)
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


def _segmented_serve_step(engine: SegmentedEngine, *, fold, k, kc, refine,
                          rerank_wmd, wmd_kw, self_exclude):
    """Serve step over a :class:`SegmentedEngine`.

    ``fold(queries, q_gid)`` gives the one-sided (B, kc) candidates: on one
    device ``engine.fold_topk`` (each segment phase-1s against its own
    restricted vocabulary and runs the fused top-k with its tombstone mask
    and, under ``self_exclude``, the query ids shifted by its offset; the
    (distance, global id) candidates merge into one top-k), under a mesh
    :func:`_mesh_segment_fold`.  The engine's device masks are copied once
    per corpus version, and tier 2's centroids (tombstoned rows out of
    reach) are remade at the first tier-2 call of a new version, so the
    SAME callable keeps serving across append, delete and compact.
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
        return _finish(engine, queries, fold(queries, q_gid), k=k, kc=kc,
                       n_cover=engine.n_live, tier=tier, refine=refine,
                       rerank_wmd=rerank_wmd, wmd_kw=wmd_kw)

    return serve


def _routed_serve_step(engine: SegmentedEngine, index, *, fold, k, kc, refine,
                       rerank_wmd, wmd_kw, self_exclude):
    """Serve step routed through a :class:`~repro_torch.index.ClusterIndex`.

    Per batch: ``index.route`` picks each query's cells, the batch's
    probed union is capped at ``index.probe_cap`` cells, and ``fold(queries,
    kc, probed, cells, keep, q_gid)`` runs each probed cell's phase 1 over
    its own vocabulary and the one-sided fused top-k with its live mask
    (under ``self_exclude``, each query's row in that cell) on the queries
    routed to it: ``index.fold_cells`` on one device,
    :func:`_mesh_cell_fold` under a mesh.  The (distance, global id)
    candidates merge into (B, kc), empty slots at (3.4e38, -1).  The
    index's live masks and the tier-2 centroids (the index's doc
    centroids, tombstoned rows out of reach) are re-read when
    ``engine.version`` or ``index.version`` moves, and only then.
    ``pruned_exact`` is relative to the routed cells, and unconditional
    only when routing kept every cell for every query.
    """
    dev = engine.device
    p_max = index.probe_cap
    state: dict = {"key": None}

    def refresh():
        index.sync_live()   # raises if the engine grew without index.add
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
        tk = topk_lib.pad_topk(
            fold(queries, kcs, probed, route.cells, keep, q_gid), kcs)
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


def build_allpairs_d1(mesh=None, *, bf16_matmul: bool = True,
                      phase1_full_mesh: bool = True, device=None):
    """All-pairs one-sided LC-RWMD: ``d1(set1, set2, emb)`` → D1 (n1, n2).

    The symmetric all-pairs bound runs it twice with the sets swapped and
    takes max(D1, D2ᵀ) (paper Sec. IV); n2 plays the role of a query batch
    and callers chunk it.  Phase 1 and the ELL SpMM are the kernels on
    ``device`` (``None`` → the mesh's device, else ``"cuda"``).  Under a
    ``mesh`` the result is this rank's row block of D1, rows
    ``local_rows(mesh, n1)``, sharded as the engine-less serve step shards
    it (``phase1_full_mesh`` likewise).
    """
    dev = _step_device(mesh, device)

    def d1(set1: DocSet, set2: DocSet, emb) -> torch.Tensor:
        set1, set2, emb = set1.to(dev), set2.to(dev), as_f32(emb, dev)
        if mesh is None:
            return lc_rwmd_one_sided(set1, set2, emb, bf16_matmul=bf16_matmul)
        return _mesh_one_sided(mesh, set1, set2, emb, bf16_matmul=bf16_matmul,
                               full_mesh=phase1_full_mesh)[0]

    return d1


# ---------------------------------------------------------------------------
# The mesh program
# ---------------------------------------------------------------------------
def _same_device(a: torch.device, b: torch.device) -> bool:
    """One device, with a CUDA device of no index read as the current one."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return a.index == b.index
    cur = torch.cuda.current_device
    return (cur() if a.index is None else a.index) == (
        cur() if b.index is None else b.index)


def _step_device(mesh, device) -> torch.device:
    """An engine-less step's device: ``device``, else the mesh's."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and not _same_device(resolve_device(device),
                                               mesh.device):
        raise ValueError(f"device {device} is not the mesh's ({mesh.device})")
    return mesh.device


def _block(n: int, parts: int, i: int) -> tuple[int, int]:
    """Block ``i`` of ``n`` rows cut into ``parts`` contiguous blocks of
    ceil(n / parts) rows (the last ones short, or empty)."""
    size = -(-n // parts)
    lo = min(i * size, n)
    return lo, min(lo + size, n)


def local_rows(mesh, n: int) -> tuple[int, int]:
    """The global rows ``[lo, hi)`` of an ``n``-row resident set that this
    rank holds: row-major over the batch axes (pod, data), contiguous."""
    b_axes = batch_axes(mesh)
    return _block(n, mesh.size_over(b_axes), mesh.index_over(b_axes))


class _Layout(NamedTuple):
    rows: tuple[int, int]   # this rank's resident rows [lo, hi)
    emb: tuple[int, int]    # this rank's embedding (vocabulary) rows
    span: tuple[int, int]   # the vocabulary span its Z covers after step 2
    shard: int              # rows of a full embedding shard


def _layout(mesh, n: int, v: int, full_mesh: bool) -> _Layout:
    """Where this rank's rows and vocabulary lie.  The embedding rows are
    cut into ceil(v / shards)-row blocks, model-major over (model, *batch
    axes) under a full mesh, over model alone otherwise: the reference's
    blocks over its zero-padded table."""
    b_axes = batch_axes(mesh)
    nb, di = mesh.size_over(b_axes), mesh.index_over(b_axes)
    nm, mi = mesh.shape[MODEL_AXIS], mesh.coords[MODEL_AXIS]
    shards, si = (nm * nb, mi * nb + di) if full_mesh else (nm, mi)
    size = -(-v // shards)
    emb = _block(v, shards, si)
    if full_mesh:
        lo = min(mi * nb * size, v)
        span = (lo, min(lo + nb * size, v))
    else:
        span = emb
    return _Layout(local_rows(mesh, n), emb, span, size)


def _span_z(mesh, z: torch.Tensor, lay: _Layout,
            full_mesh: bool) -> torch.Tensor:
    """This rank's Z slice as its model span's Z: under a full mesh the
    slices of the batch axes, each padded to a whole shard, are gathered
    (innermost axis first) and the padding cut off."""
    if not full_mesh:
        return z
    pad = lay.shard - z.shape[0]
    if pad:
        z = torch.cat([z, z.new_zeros((pad, z.shape[1]))])
    z = mesh.all_gather(z, tuple(reversed(batch_axes(mesh))), dim=0)
    return z[:lay.span[1] - lay.span[0]]


def _span_ids(ids: torch.Tensor, w: torch.Tensor, span: tuple[int, int],
              v: int):
    """ELL ids and weights against the vocabulary span ``[lo, hi)``: ids
    made span-relative, and slots outside the span at weight 0 and id 0
    (the SpMM reads no id of a zero-weight slot).  No pass when the span is
    the whole vocabulary."""
    lo, hi = span
    if lo == 0 and hi >= v:
        return ids, w
    rel = ids - lo
    inb = (rel >= 0) & (rel < hi - lo)
    return (torch.where(inb, rel, 0).to(torch.int32).contiguous(),
            torch.where(inb, w, 0.0).contiguous())


def _phase1_z(emb_loc: torch.Tensor, t_q: torch.Tensor, q_w: torch.Tensor,
              *, bf16_matmul: bool) -> torch.Tensor:
    """Z (rows of ``emb_loc``, B) by the phase-1 kernel; none for no rows."""
    if emb_loc.shape[0] == 0:
        return t_q.new_zeros((0, q_w.shape[0]))
    return _phase1_from_t(emb_loc, t_q, q_w, bf16_matmul=bf16_matmul)


def _spmm(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The ELL SpMM kernel; (0, B) for no rows, zeros for an empty span
    (every slot lies outside it and weighs 0)."""
    if ids.shape[0] == 0 or z.shape[0] == 0:
        return z.new_zeros((ids.shape[0], z.shape[1]))
    return ops.spmm_ell(ids, w, z)


def _mesh_one_sided(mesh, resident: DocSet, queries: DocSet,
                    emb: torch.Tensor, *, bf16_matmul: bool, full_mesh: bool):
    """The engine-less shard program: this rank's rows of D1 (n_local, B)
    after the psum over model, and their global row range."""
    v = emb.shape[0]
    lay = _layout(mesh, resident.n_docs, v, full_mesh)
    (e_lo, e_hi), (r_lo, r_hi) = lay.emb, lay.rows
    emb_loc = emb[e_lo:e_hi]
    b_axes = batch_axes(mesh)
    # 1. the query embeddings: a masked gather of this rank's rows, summed
    rel = queries.ids.long() - e_lo
    inb = (rel >= 0) & (rel < e_hi - e_lo)
    if e_hi > e_lo:
        t_q = torch.where(inb[..., None],
                          emb_loc[rel.clamp(0, e_hi - e_lo - 1)], 0.0)
    else:
        t_q = emb.new_zeros((*queries.ids.shape, emb.shape[1]))
    t_q = mesh.psum(t_q, (*b_axes, MODEL_AXIS) if full_mesh else (MODEL_AXIS,))
    # 2. phase 1 on this rank's rows, as its model span's Z
    z = _span_z(mesh, _phase1_z(emb_loc, t_q.reshape(-1, emb.shape[1]),
                                queries.weights, bf16_matmul=bf16_matmul),
                lay, full_mesh)
    # 3. the phase-2 partial of this rank's rows, summed over model
    ids, w = _span_ids(resident.ids[r_lo:r_hi], resident.weights[r_lo:r_hi],
                       lay.span, v)
    return mesh.psum(_spmm(ids, w, z), (MODEL_AXIS,)), lay.rows


class _Shard(NamedTuple):
    """This rank's part of one resident corpus (an engine's, a segment's or
    a cell's): its rows' ELL ids and weights against its model span, its
    rows of the restricted embedding table, and where they lie."""
    lay: _Layout
    emb: torch.Tensor   # (e_hi - e_lo, m)
    ids: torch.Tensor   # (n_loc, h1) span-relative ids
    w: torch.Tensor     # (n_loc, h1)


def _shard(mesh, t: SegmentTensors, full_mesh: bool) -> _Shard:
    v = t.emb_r.shape[0]
    lay = _layout(mesh, t.r_ids.shape[0], v, full_mesh)
    (r_lo, r_hi), (e_lo, e_hi) = lay.rows, lay.emb
    ids, w = _span_ids(t.r_ids[r_lo:r_hi].contiguous(),
                       t.r_w[r_lo:r_hi].contiguous(), lay.span, v)
    return _Shard(lay, t.emb_r[e_lo:e_hi].contiguous(), ids, w)


def _shard_z(mesh, sh: _Shard, t_q: torch.Tensor, q_w: torch.Tensor, *,
             bf16_matmul: bool, full_mesh: bool) -> torch.Tensor:
    """Phase 1 on the rank's vocabulary rows, as its model span's Z.  Every
    rank runs it, rows or none: under a full mesh it joins the gather."""
    return _span_z(mesh, _phase1_z(sh.emb, t_q, q_w, bf16_matmul=bf16_matmul),
                   sh.lay, full_mesh)


def _shard_topk(mesh, sh: _Shard, z: torch.Tensor, kc: int, *,
                row_block: int, slab: int, live: torch.Tensor | None,
                q_row: torch.Tensor | None) -> TopK | None:
    """The rank's candidates of one resident corpus: TopK (B, min(kc,
    n_loc)), ids counted from the corpus's first row (unfilled slots -1),
    or None for a rank with no rows.

    ``live`` (n_loc,): the rank's slice of the live mask; ``q_row`` (B,):
    each query's own row in the corpus (any other value excludes nothing).
    ``model`` = 1: the fused top-k kernel on the rank's rows.  ``model`` >
    1: slabs of ``slab`` rows through the ELL SpMM kernel, one psum over
    model a slab, the masks, and a fold into a carry; the ranks of a model
    line hold the same rows, so they issue the same psums.
    """
    n_loc = sh.ids.shape[0]
    r_lo = sh.lay.rows[0]
    if not n_loc:
        return None
    if mesh.shape[MODEL_AXIS] == 1:
        d, i = ops.streaming_phase2_topk(
            sh.ids, sh.w, z, min(kc, n_loc), row_block=row_block,
            q_gid=None if q_row is None else q_row - r_lo, row_valid=live)
        return _offset_topk(TopK(d, i), r_lo)
    stk = topk_lib.StreamingTopK(min(kc, n_loc))
    carry = stk.init(z.shape[1], device=z.device)
    for lo in range(0, n_loc, slab):
        hi = min(lo + slab, n_loc)
        d = mesh.psum(_spmm(sh.ids[lo:hi], sh.w[lo:hi], z),
                      (MODEL_AXIS,))                               # (R, B)
        rows = torch.arange(r_lo + lo, r_lo + hi, dtype=torch.int32,
                            device=z.device)
        carry = stk.update(carry, *topk_lib.masked_entries(
            d.T, rows, None if live is None else live[lo:hi], q_row))
    return carry


def _merge_local(parts: list, b: int, kc: int, dev) -> TopK:
    """The rank's parts merged into one (B, min(kc, Σ widths)) carry."""
    if not parts:
        return TopK(torch.empty((b, 0), device=dev),
                    torch.empty((b, 0), dtype=torch.int32, device=dev))
    width = sum(p.dists.shape[1] for p in parts)
    if len(parts) == 1 and width <= kc:
        return parts[0]
    return topk_lib.merge_topk(parts, min(kc, width))


def _mesh_engine_serve_step(mesh, engine: LCRWMDEngine, *, k, kc, refine,
                            bf16_matmul, full_mesh, rerank_wmd, wmd_kw,
                            self_exclude, streaming, row_block, psum_batch):
    """Serve step over a monolithic :class:`LCRWMDEngine` on a mesh.

    Built once: this rank's rows of the engine's restricted ids and
    weights (made relative to its model span) and its rows of the
    restricted embedding table; the engine is the caller's.  A call
    gathers the query targets from the full table, runs phase 1 on the
    rank's vocabulary rows, and then:

      * streaming: the rank's candidates by :func:`_shard_topk`
        (self-exclusion by ``q_gid``), then the cross-rank top-k over the
        batch axes;
      * ``streaming=False``: the ELL SpMM on the rank's rows, a psum over
        model, the self mask, then ``distributed_topk``.

    A monolithic engine has no tombstones, so no ``row_valid`` is passed;
    the port pads no rows, so none needs masking.  Tiers 0–2, the refine
    and the rerank run replicated, as in the one-device step.
    """
    dev = engine.device
    n_real = engine.resident.n_docs
    sh = _shard(mesh, engine._segment_tensors(), full_mesh)
    r_lo, r_hi = sh.lay.rows
    b_axes = batch_axes(mesh)
    slab = max(1, row_block) * max(1, psum_batch)
    state: dict = {}

    def candidates(z, b, q_gid):
        if not streaming:
            d = mesh.psum(_spmm(sh.ids, sh.w, z), (MODEL_AXIS,))
            if q_gid is not None:
                rows = torch.arange(r_lo, r_hi, dtype=torch.int32, device=dev)
                d = d.masked_fill(rows[:, None] == q_gid[None, :], _INF)
            return topk_lib.distributed_topk(d, kc, mesh=mesh,
                                             axis_names=b_axes,
                                             shard_offset=r_lo), d
        part = _shard_topk(mesh, sh, z, kc, row_block=row_block, slab=slab,
                           live=None, q_row=q_gid)
        local = _merge_local([] if part is None else [part], b, kc, dev)
        return topk_lib.crossshard_topk(local, kc, mesh=mesh,
                                        axis_names=b_axes), None

    def serve(queries: DocSet, query_ids=None, *, tier: int = 0) -> ServeResult:
        tier = int(tier)
        queries = queries.to(dev)
        q_gid = _query_gids(self_exclude, queries, query_ids, dev)
        if tier >= 2:   # QualityTier.WCD, replicated
            if "cent" not in state:
                state["cent"] = resident_centroids(engine.resident,
                                                   engine.emb_full)
            return ServeResult(
                topk=_wcd_topk(k, state["cent"], engine, queries, q_gid),
                d_local=None, tier=tier)
        z = _shard_z(mesh, sh, engine._gather_flat(queries.ids),
                     queries.weights, bf16_matmul=bf16_matmul,
                     full_mesh=full_mesh)
        tk, d_local = candidates(z, queries.n_docs, q_gid)
        return _finish(engine, queries, tk, k=k, kc=kc, n_cover=n_real,
                       tier=tier, refine=refine, rerank_wmd=rerank_wmd,
                       wmd_kw=wmd_kw, d_local=d_local)

    return serve


def _reuse(old: list, parts, make) -> list:
    """``(part, make(part))`` for each of ``parts``, reusing the entry of
    ``old`` made for the same object (a part whose tensors did not change
    keeps its slices)."""
    out = []
    for part in parts:
        hit = next((sh for p, sh in old if p is part), None)
        out.append((part, make(part) if hit is None else hit))
    return out


def _mesh_segment_fold(mesh, engine: SegmentedEngine, *, kc, bf16_matmul,
                       full_mesh, row_block, psum_batch):
    """The segmented step's candidates on a mesh: ``fold(queries, q_gid)``
    → the (B, kc) TopK every rank holds.

    Each segment's rows are cut over the batch axes and its restricted
    table over model (or the whole mesh), as the monolithic step cuts the
    engine's.  Per segment: phase 1 on the rank's vocabulary rows, then
    :func:`_shard_topk` on its rows with its slice of the segment's live
    mask and each query's id less the segment's offset; the ids are made
    global by the offset.  Every segment folds into one carry, and one
    cross-rank top-k over the batch axes follows the last.  The rank's
    slices are made once per segment object (a delete changes only the
    masks; ``append`` adds a segment; ``compact`` replaces them), its
    masks once per ``engine.version``.
    """
    b_axes = batch_axes(mesh)
    slab = max(1, row_block) * max(1, psum_batch)
    state: dict = {"version": None, "shards": []}

    def refresh():
        if state["version"] == engine.version:
            return
        state["shards"] = _reuse(state["shards"], engine.segments,
                                 lambda seg: _shard(mesh, seg.tensors,
                                                    full_mesh))
        state["live"] = [live[slice(*sh.lay.rows)] for (_, sh), live in zip(
            state["shards"], engine.segment_live_device())]
        state["version"] = engine.version

    def fold(queries: DocSet, q_gid) -> TopK:
        refresh()
        t_q = engine._gather_flat(queries.ids)
        parts = []
        for (seg, sh), live in zip(state["shards"], state["live"]):
            z = _shard_z(mesh, sh, t_q, queries.weights,
                         bf16_matmul=bf16_matmul, full_mesh=full_mesh)
            tk = _shard_topk(mesh, sh, z, kc, row_block=row_block, slab=slab,
                             live=live, q_row=None if q_gid is None
                             else q_gid - seg.offset)
            if tk is not None:
                parts.append(_offset_topk(tk, seg.offset))
        local = _merge_local(parts, queries.n_docs, kc, engine.device)
        return topk_lib.crossshard_topk(local, kc, mesh=mesh,
                                        axis_names=b_axes)

    return fold


def _mesh_cell_fold(mesh, engine: SegmentedEngine, index, *, bf16_matmul,
                    full_mesh, row_block, psum_batch):
    """The routed step's candidates on a mesh: ``fold(queries, kc, probed,
    cells, keep, q_gid)`` → the (B, kc) TopK every rank holds.

    Each cell's rows are cut over the batch axes and its restricted table
    over model (or the whole mesh).  Each probed cell runs on its routed
    queries only, as ``ClusterIndex.fold_cells`` does: phase 1 on the
    rank's vocabulary rows, then :func:`_shard_topk` on its rows with its
    slice of the cell's live mask and each query's row in the cell (-1
    for a query whose doc is not a member); ids are made global through
    the cell's gid table.  A rank with no row of a cell still runs its
    phase 1 (and its part of the gathers and psums).  All cells fold into
    one carry, then one cross-rank top-k.  The routing is replicated: every
    rank routes the same batch from the same state to the same cells.
    """
    dev = engine.device
    b_axes = batch_axes(mesh)
    slab = max(1, row_block) * max(1, psum_batch)
    state: dict = {"key": None, "shards": []}

    def refresh():
        index.sync_live()
        key = (engine.version, index.version)
        if state["key"] == key:
            return
        alive = [c for c, cell in enumerate(index.cells) if cell is not None]
        state["shards"] = _reuse(
            state["shards"], [index.cells[c] for c in alive],
            lambda cell: _shard(mesh, cell.segment.tensors, full_mesh))
        state["cells"] = {
            c: (cell, sh, index.cell_live(c)[slice(*sh.lay.rows)])
            for c, (cell, sh) in zip(alive, state["shards"])}
        state["key"] = key

    def fold(queries: DocSet, kc: int, probed, cells: np.ndarray,
             keep: np.ndarray, q_gid) -> TopK:
        refresh()
        b = queries.n_docs
        t_q = engine.gather_queries(queries.ids)                 # (B, h, m)
        rows = None if q_gid is None else index.query_rows(q_gid)
        parts = []
        for c in np.asarray(probed, dtype=np.int64):
            qmask = ((cells == c) & keep).any(axis=1)
            if int(c) not in state["cells"] or not qmask.any():
                continue
            cell, sh, live = state["cells"][int(c)]
            every = bool(qmask.all())
            sel = (slice(None) if every else
                   torch.from_numpy(np.nonzero(qmask)[0]).to(dev))
            tq = t_q[sel]
            z = _shard_z(mesh, sh, tq.reshape(-1, tq.shape[-1]),
                         queries.weights[sel], bf16_matmul=bf16_matmul,
                         full_mesh=full_mesh)
            q_row = None if rows is None else torch.where(
                rows[0] == int(c), rows[1], -1).to(torch.int32)[sel]
            tk = _shard_topk(mesh, sh, z, kc, row_block=row_block, slab=slab,
                             live=live, q_row=q_row)
            if tk is None:
                continue
            filled = tk.indices >= 0
            g = torch.where(filled, cell.gids[tk.indices.clamp(min=0).long()],
                            -1)
            d = torch.where(filled, tk.dists, float("inf"))
            if not every:
                full_d = torch.full((b, d.shape[1]), float("inf"), device=dev)
                full_i = torch.full((b, d.shape[1]), -1, dtype=torch.int32,
                                    device=dev)
                full_d[sel], full_i[sel] = d, g
                d, g = full_d, full_i
            parts.append(TopK(d, g))
        return topk_lib.crossshard_topk(_merge_local(parts, b, kc, dev), kc,
                                        mesh=mesh, axis_names=b_axes)

    return fold


def _collectives(obs, variant: str, mesh, serve):
    """``serve`` with its first tier-0 or tier-1 call's collectives set
    into ``obs``'s ``serve_step_collectives_{psum,all_gather}{variant=...}``
    gauges (``serve`` itself without an ``obs`` or a mesh)."""
    if obs is None or mesh is None:
        return serve
    done = [False]

    def counted(queries: DocSet, query_ids=None, *, tier: int = 0):
        if done[0] or int(tier) >= 2 or not obs.metrics.enabled:
            return serve(queries, query_ids, tier=tier)
        before = dict(mesh.counts)
        out = serve(queries, query_ids, tier=tier)
        done[0] = True
        for name in ("psum", "all_gather"):
            obs.metrics.gauge(
                f"serve_step_collectives_{name}",
                "Collectives the mesh issued in one serve-step call (none "
                "over an axis of size 1).", labels={"variant": variant}).set(
                    mesh.counts[name] - before.get(name, 0))
        return out

    return counted
