"""LC-RWMD query serving: batched similarity against a resident corpus (the
counterpart of ``repro.serving.query_server``, on one device or a mesh).

Production loop per the paper's deployment (Sec. VI): a RESIDENT document
set is loaded once onto the card; TRANSIENT query documents stream in, are
micro-batched, vectorized against the resident vocabulary, and answered
with top-k nearest documents.  Optional refinement stages tighten the
LC-RWMD lower bound per the pruning cascade:

    LC-RWMD (all residents)  ->  top-k  ->  [symmetric RWMD refine]
                                         ->  [Sinkhorn-WMD re-rank]

Two front-ends share one serving core (:class:`_ServeCore` — engine build,
host batching, serve-step dispatch, adaptive-budget feedback):

* :class:`QueryServer` — the synchronous reference server.  ``submit`` +
  ``flush`` / ``serve_stream`` run host prep, device serve, and result
  readback in lock-step; simple, deterministic, the parity oracle.

* :class:`AsyncQueryServer` — the double-buffered pipeline.  ``submit``
  returns a :class:`ServeFuture` immediately (bounded pending queue;
  backpressure blocks the producer at capacity); a worker thread batches
  and DISPATCHES batch *i+1*'s host prep while batch *i* executes on the
  device.  On the card a dispatch queues the serve step's kernels and
  non-blocking copies of its results into pinned host buffers, then
  records a CUDA event; ``collect`` waits on that event.  Up to
  ``ServerConfig.pipeline_depth`` batches are in flight, and futures
  always resolve in submission order.  On the CPU (``device="cpu"``, the
  kernels' plain versions) a batch is done when its dispatch returns.

One stream: the serve loop, and ingest/delete/compact on the caller's
thread under ``manager.lock``, all issue their CUDA work on the device's
current (default) stream.  Host order under the lock is therefore device
order, and the caching allocator cannot hand a tensor an in-flight batch
still reads to another stream; no tensor crosses streams.

Fault tolerance (the serving contract): every accepted query resolves with
either an :class:`Answer` or a typed :class:`~repro_torch.serving.errors
.ServingError` — no caller ever blocks forever.

* Deadlines — ``submit(..., deadline=s)`` sets a per-request budget.
  Admission control rejects queries whose deadline cannot be met
  (:class:`QueryRejected`); queued queries whose deadline lapses are swept
  (:class:`DeadlineExceeded`); the batcher RUSHES a partial batch when the
  earliest pending deadline approaches.
* Degradation — with ``cfg.degradation`` a :class:`DegradationController`
  steps the pruning cascade down (full rerank -> LC-RWMD-only -> WCD
  shortlist) under queue/deadline/fault pressure and back up when it
  clears.  Each :class:`Answer` is stamped with the ``tier`` it was served
  at.  Tier switches reuse ONE serve step (the tier is a dispatch-time
  argument, not a rebuild).
* Validation — non-finite top-k distances trigger a bisection retry that
  isolates the poison query and quarantines it with a per-query
  :class:`PoisonQuery`; its batch-mates keep their (recomputed) answers.
* Supervision — the async worker catches any worker-thread death, fails
  in-flight futures with :class:`WorkerCrashed`, restarts the serve loop
  preserving submission order, and gives up (failing everything with
  :class:`ServerClosed`) after ``cfg.max_worker_restarts``.  A CUDA error
  (an illegal address, a failed launch of a sticky kind) leaves the
  device context unusable, so it is handled as a crash that is not
  restarted: the batch fails with :class:`WorkerCrashed`, the server
  closes, and every other unresolved future fails with
  :class:`ServerClosed`.  Nothing is ever re-run on the CPU or on a
  kernel's plain version.  ``health()`` snapshots queue depth, in-flight
  count, liveness, tier, and counters.
* Fault injection — a deterministic :class:`~repro_torch.serving.faults
  .FaultPlan` may be installed via ``faults=`` to exercise all of the
  above; see ``serving/faults.py``.

Both servers preserve the
:class:`~repro_torch.distributed.lcrwmd_dist.ServeResult` contract —
``pruned_exact`` certificates feed the adaptive rerank budget, whose
changes rebuild the serve step (O(log) times), with the full trajectory
recorded in ``stats``.

Meshes: ``QueryServer(..., mesh=)`` serves through the mesh program of
:mod:`repro_torch.distributed.lcrwmd_dist` (one process a rank, each rank
running the same server on the same stream; the reference drives every
device from one controller and takes ``mesh`` positionally).  Under a mesh
of more than one rank the decisions that read the clock (which queries'
deadlines lapsed, the queue depth the degradation tier is chosen from, and
``serve_stream``'s flushes) are rank 0's, shared by one small
``all_gather`` over the whole mesh before the step is called, so every
rank serves the same queries at the same tier.  ``AsyncQueryServer(...,
mesh=)`` keeps that model: every rank runs the same server and gets the
same submissions and corpus changes in the same order, and rank 0's
worker decides each step of the pipeline (the entries that leave the
queue head, the lapsed and rejected ones, the queue depth that picks the
tier, the corpus changes applied first, a collect, the exit) and shares
the decision by one fixed-length ``all_gather`` (the lapsed positions
follow at the length it gives) before any rank acts on it.  A follower
waits for the entries rank 0 named, prepares them, and serves the batch
only if every rank's digest of the padded ids and weights is rank 0's;
the answers' delivery-time deadline checks are rank 0's too.  Corpus
changes queue for the worker, which applies them at the boundary rank 0
names.  The async worker runs this one loop on any number of ranks: on
one, the decision is its own and no collective is issued.  On a mesh of
one rank both servers are the mesh-less ones bit for bit.

Differences from the reference: ``mesh`` is a keyword;
``ServerConfig`` has ``device`` and no ``delta_pad`` /
``vocab_pad`` / ``streaming_topk`` (nothing here reads the last); a batch
is served at its real query count, each query padded or truncated to
``h_max`` words (the reference pads every batch to
``(max_batch, h_max)`` for one jit shape; the port's kernels take any
shape, and padded queries would cost phase-1 columns, top-k columns,
rerank pairs and d21 work for nothing).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import hashlib
import re
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Sequence

import numpy as np

import torch

from repro_torch.core.lc_rwmd import SegmentedEngine
from repro_torch.core.pipeline import AdaptiveRefineBudget
from repro_torch.data.docs import DocSet
from repro_torch.device import resolve_device
from repro_torch.distributed.lcrwmd_dist import (
    ServeResult,
    _same_device,
    build_serve_step,
)
from repro_torch.obs import (
    COUNT_BUCKETS,
    BudgetRebuild,
    Observability,
    QueryQuarantined,
    TierTransition,
    WorkerRestart,
    sentinel,
)
from repro_torch.serving.corpus_manager import (
    DEFAULT_CORPUS,
    CorpusManager,
    CorpusState,
)
from repro_torch.serving.errors import (
    DeadlineExceeded,
    MeshDivergence,
    PoisonQuery,
    QueryRejected,
    ServerClosed,
    ServingError,
    WorkerCrashed,
)
from repro_torch.serving.staging import pad_batch


class Answer(tuple):
    """One answered query: ``(doc_ids (k,), distances (k,))``, ascending.

    A plain 2-tuple (unpacks as ``ids, dists = answer``) carrying one extra
    attribute: ``tier`` — the degradation tier the answer was served at
    (0 = full cascade, 1 = LC-RWMD only, 2 = WCD shortlist).
    """

    #: Completed :class:`repro_torch.obs.QueryTrace` (None when tracing is
    #: off).
    trace = None

    def __new__(cls, ids: np.ndarray, dists: np.ndarray, tier: int = 0):
        self = super().__new__(cls, (ids, dists))
        self.tier = int(tier)
        return self


#: One pending query: (ids (h,), weights (h,)) numpy histograms — or, when a
#: ``preprocess`` hook is installed, whatever raw payload that hook accepts.
QueryLike = Any


@dataclasses.dataclass
class ServerConfig:
    k: int = 16
    max_batch: int = 64
    max_wait_s: float = 0.01
    h_max: int = 32
    refine_symmetric: bool = True
    rerank_wmd: bool = False        # exact-style re-rank of the top-k
    wmd_kw: dict = dataclasses.field(
        default_factory=lambda: dict(eps=0.02, eps_scaling=3, max_iters=200))
    # Adaptive rerank budget (rerank_wmd only): grow on pruning failures,
    # halve after `budget_decay_after` consecutive all-exact batches.  A
    # budget change rebuilds the serve step (O(log) times).
    adaptive_budget: bool = False
    budget_decay_after: int | None = 4
    # Async pipeline knobs (AsyncQueryServer only):
    queue_capacity: int | None = None  # pending-query bound; default 4*max_batch
    pipeline_depth: int = 2            # device batches in flight (2 = double buffer)
    # Multi-process host plane (AsyncQueryServer only): with N > 0, raw
    # payloads vectorize in N spawned ingest worker PROCESSES feeding the
    # dispatcher through a zero-copy shared-memory staging ring.  Requires
    # a picklable ``preprocess`` hook (spawn re-imports its module in each
    # child — dataclass vectorizers qualify, closures don't).  0 keeps the
    # in-thread prep path (and is what the sync server always uses).
    ingest_workers: int = 0
    staging_slots: int | None = None   # ring slots; default 4*max_batch
    ingest_timeout_s: float = 30.0     # per-ticket staging-ring wait bound
    # Fault tolerance:
    admission_control: bool = True     # reject at submit when deadline unmeetable
    validate_results: bool = True      # non-finite check + bisection quarantine
    degradation: bool = False          # tier shedding under pressure
    shed_queue_depth: int | None = None  # down-step threshold; default 2*max_batch
    recover_after: int = 4             # healthy dispatches before up-step
    fail_streak_down: int = 2          # consecutive stage failures before down-step
    max_tier: int = 2                  # deepest shed (2 = WCD shortlist)
    max_worker_restarts: int = 3       # supervisor gives up past this
    # Cluster-routed serving (repro_torch.index): an IndexConfig builds one
    # ClusterIndex per corpus — serve batches route to top-p cells instead
    # of scanning the whole corpus (O(n) → O(n/cells · p) per query).
    index: Any = None                  # repro_torch.index.IndexConfig | None
    # Corpus lifecycle / multi-tenancy (CorpusManager):
    cache_bytes: int | None = None     # device-byte LRU budget; None = no evict
    dedup_threshold: float | None = None  # default near-dup ingest gate
    # Observability (repro_torch.obs):
    observability: bool = True         # metrics registry + event log
    tracing: bool = True               # per-query span timelines
    obs: Any = None                    # share an Observability bundle; None
    #                                    = each server owns a fresh one
    # Device of the corpora and the serve steps: None = "cuda" (raises
    # without a card); "cpu" runs each kernel's plain version.
    device: Any = None


@dataclasses.dataclass
class DegradationController:
    """Load/fault-aware cascade shedding for the serving core.

    Tiers index :class:`repro_torch.core.pipeline.QualityTier`: 0 = full cascade
    (LC-RWMD + refine/rerank), 1 = LC-RWMD top-k only, 2 = WCD centroid
    shortlist.  Down-steps are immediate on pressure signals (queue depth
    at ``shed_queue_depth``, a deadline miss, a worker crash, or
    ``fail_streak_down`` consecutive stage failures); the up-step is
    conservative (``recover_after`` consecutive dispatches with the queue
    at most half the shed threshold).  Every transition is recorded in
    ``transitions`` (shared with server ``stats["tier_transitions"]``).
    """

    shed_queue_depth: int = 128
    max_tier: int = 2
    recover_after: int = 4
    fail_streak_down: int = 2
    tier: int = 0
    transitions: list = dataclasses.field(default_factory=list)
    obs: Any = dataclasses.field(default=None, repr=False, compare=False)
    _healthy: int = dataclasses.field(default=0, init=False, repr=False)
    _fail_streak: int = dataclasses.field(default=0, init=False, repr=False)

    def observe_dispatch(self, queue_depth: int) -> int:
        """Called once per batch dispatch; returns the tier to serve at."""
        if queue_depth >= self.shed_queue_depth:
            self._down(f"queue depth {queue_depth} >= {self.shed_queue_depth}")
        elif self.tier > 0 and queue_depth <= self.shed_queue_depth // 2:
            self._healthy += 1
            if self._healthy >= self.recover_after:
                self._up("pressure cleared")
        return self.tier

    def note_success(self) -> None:
        self._fail_streak = 0

    def note_stage_failure(self) -> None:
        self._fail_streak += 1
        if self._fail_streak >= self.fail_streak_down:
            self._fail_streak = 0
            self._down("repeated stage failures")

    def note_deadline_miss(self) -> None:
        self._down("deadline miss")

    def note_crash(self) -> None:
        self._down("worker crash")

    def _down(self, reason: str) -> None:
        self._healthy = 0
        if self.tier < self.max_tier:
            self.tier += 1
            self.transitions.append({"tier": self.tier, "reason": reason})
            self._emit(reason)

    def _up(self, reason: str) -> None:
        self._healthy = 0
        if self.tier > 0:
            self.tier -= 1
            self.transitions.append({"tier": self.tier, "reason": reason})
            self._emit(reason)

    def _emit(self, reason: str) -> None:
        if self.obs is not None:
            self.obs.events.append(TierTransition(tier=self.tier,
                                                  reason=reason))
            self.obs.metrics.gauge(
                "serving_tier", "current degradation tier").set(self.tier)


class ServeFuture(concurrent.futures.Future):
    """Completion handle for one submitted query.

    ``result(timeout=None)`` blocks for and returns the :class:`Answer`
    ``(doc_ids (k,), distances (k,))`` — or raises that query's typed
    :class:`~repro_torch.serving.errors.ServingError`; inside a coroutine the
    future can be ``await``-ed directly.  Resolution order across futures
    equals submission order (the pipeline collects batches FIFO).
    """

    #: Completed :class:`repro_torch.obs.QueryTrace` of this request, set at
    #: resolution time (None when tracing is off or the request failed
    #: with a shared, non-per-query error instance).
    trace = None

    def __await__(self):
        return asyncio.wrap_future(self).__await__()


class _InFlight(NamedTuple):
    """A dispatched-but-uncollected batch: device handles + bookkeeping."""

    result: ServeResult  # device tensors (kernels queued, not yet awaited)
    n_real: int          # real (non-padding) queries in the batch
    seq: int             # dispatch sequence number (trace/debug)
    qs: tuple = ()       # the real query histograms (validation retries)
    tier: int = 0        # degradation tier the batch was served at
    t0: float = 0.0      # dispatch wall-clock (latency EWMA)
    state: Any = None    # CorpusState the batch was served against
    traces: tuple = ()   # per-query QueryTraces (aligned with qs; may be empty)
    btrace: Any = None   # shared BatchTrace (None when tracing is off)
    host: tuple = ()     # (indices, dists, pruned_exact|None) host tensors
    event: Any = None    # CUDA event after the copies into `host` (None: CPU)


class _Staged(NamedTuple):
    """Queue payload marker: this query's raw payload went to the ingest
    pool; its vectorized histogram arrives via staging-ring ``ticket``."""

    ticket: int


def _check_query(ids, weights) -> None:
    """Host-side poison screen: a query with no positive finite mass can
    never be served (its normalized histogram is NaN)."""
    w = np.asarray(weights, dtype=np.float32).reshape(-1)
    if w.size == 0 or not np.isfinite(w).all() or not (w > 0).any():
        raise PoisonQuery(
            "query has no in-vocabulary mass (empty, all-zero, or "
            "non-finite weight vector)")


def _batch_digest(padded: tuple[np.ndarray, np.ndarray] | None) -> int:
    """An int64 digest of a batch's padded ids and weights (None: an empty
    batch): what the ranks of a mesh compare before they serve it."""
    h = hashlib.blake2b(digest_size=8)
    if padded is not None:
        ids, w = padded
        h.update(struct.pack("<q", len(ids)))
        h.update(ids.tobytes())
        h.update(w.tobytes())
    return struct.unpack("<q", h.digest())[0]


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def _bits_f64(b: int) -> float:
    return struct.unpack("<d", struct.pack("<q", b))[0]


# The steps of the worker's pipeline, as rank 0 (on one rank, the only one)
# decides them.
# A decision is [op, changes, drops, take, depth, need]: apply the first
# `changes` queued corpus changes; drop `drops` queue entries (lapsed or
# rejected; their positions follow); then `op`: serve the `take` entries
# at the queue head at the tier `depth` picks, collect the oldest batch in
# flight, exit, or nothing more.  A follower acts once its queue holds
# `need` entries.
_OP_IDLE, _OP_BATCH, _OP_COLLECT, _OP_EXIT = range(4)
_MESH_IDLE_S = 1.0   # rank 0 sends an empty decision after this long idle


def _as_serving_error(e: BaseException, context: str) -> ServingError:
    if isinstance(e, ServingError):
        return e
    err = ServingError(f"{context}: {type(e).__name__}: {e}")
    err.__cause__ = e
    return err


#: CUDA error codes after which the context is unusable (cudaError_t 700
#: onwards: illegal address, launch failure, assert, ...); a refused launch
#: (too many threads, too much shared memory) is not among them.
_STICKY_CUDA = re.compile(r"CUDA error|cudaError (7\d\d|8\d\d|9\d\d)")


def _is_device_fault(e: BaseException) -> bool:
    """A CUDA error that leaves the device context unusable."""
    return isinstance(e, RuntimeError) and bool(_STICKY_CUDA.search(str(e)))


class _DeviceFault(BaseException):
    """Escapes the per-batch typed forwarding to the supervisor, which fails
    the batch and closes the server instead of restarting a loop that
    would only fail again on the same context."""


class _ServeCore:
    """Shared serving core: corpus cache, serve steps, host batching, budgets.

    ``dispatch`` is the non-blocking half (host prep, the serve-step call,
    then non-blocking copies of the results into pinned host buffers and a
    CUDA event behind them); ``collect`` is the blocking half (a wait on
    that event, validation, stats, adaptive-budget feedback + rebuild).
    The synchronous server calls them back-to-back; the async
    pipeline keeps up to ``pipeline_depth`` dispatched batches open between
    them.  An optional :class:`DegradationController` picks the serve tier
    per dispatch; an optional fault injector exercises the failure paths.

    Corpora live in a :class:`CorpusManager` (LRU engine cache with
    device-byte eviction).  Each batch is served against ONE corpus — the
    ``corpus_id`` of its queries — through that corpus's own serve step and
    adaptive budget; the ``engine`` / ``budget`` /
    ``_serve`` attributes view the ACTIVE (most recently dispatched)
    corpus, which is the default corpus for single-tenant callers.
    """

    def __init__(self, resident: DocSet, emb, cfg: ServerConfig,
                 faults=None, mesh=None):
        self.resident = resident
        self.cfg = cfg
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(cfg.device)
        elif cfg.device is None or _same_device(resolve_device(cfg.device),
                                                mesh.device):
            self.device = mesh.device
        else:
            raise ValueError(f"ServerConfig.device {cfg.device!r} is not the "
                             f"mesh's ({mesh.device})")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if faults is not None and not hasattr(faults, "on_dispatch"):
            # Accept a bare FaultPlan for ergonomics.
            from repro_torch.serving.faults import FaultInjector
            faults = FaultInjector(faults)
        self.faults = faults
        self.obs = cfg.obs if cfg.obs is not None else Observability(
            metrics_enabled=cfg.observability, tracing_enabled=cfg.tracing)
        # Metric handles are resolved once here; the per-flush cost of a
        # disabled registry is one attribute check per record call.
        m = self.obs.metrics
        self._m_queries = m.counter(
            "serving_queries_total", "queries dispatched to the device")
        self._m_batches = m.counter(
            "serving_batches_total", "batches dispatched")
        self._m_batch_size = m.histogram(
            "serving_batch_size", "real queries per dispatched batch",
            buckets=COUNT_BUCKETS)
        self._m_dispatch = m.histogram(
            "serving_dispatch_host_seconds",
            "host time in dispatch (pad + serve-step launch)")
        self._m_collect = m.histogram(
            "serving_device_collect_seconds",
            "wait for the batch's device results at collect")
        self._m_e2e = m.histogram(
            "serving_e2e_latency_seconds",
            "dispatch-to-answers wall time per batch")
        self._m_queue_wait = m.histogram(
            "serving_queue_wait_seconds",
            "admission-to-dequeue wait per query")
        self._m_queue_depth = m.gauge(
            "serving_queue_depth", "pending queries at dispatch")
        self._m_ewma = m.gauge(
            "serving_ewma_latency_seconds",
            "EWMA batch latency driving deadline rush-dispatch "
            "(0 until seeded by the first collected batch)")
        self._m_budget = m.gauge(
            "serving_rerank_budget", "current adaptive rerank budget")
        # All resident-side prep (vocab restriction, placement on the card)
        # happens ONCE per corpus (and once per ingested delta SEGMENT —
        # O(delta), not O(corpus)); per-flush work is only the transient
        # query batch.  The WMD re-rank (when enabled) runs INSIDE the
        # serve step as one Sinkhorn-WMD kernel call over the LC-RWMD
        # top-budget candidates.  Candidate selection runs in the fused
        # top-k kernel: the (n, B) distance block is never stored on the
        # flush hot path.
        self.manager = CorpusManager(
            emb, device=self.device, cache_bytes=cfg.cache_bytes,
            make_budget=self._make_budget,
            make_index=self._make_index if cfg.index is not None else None,
            dedup_threshold=cfg.dedup_threshold, obs=self.obs)
        self.emb = self.manager.emb
        self._active = self.manager.add_corpus(DEFAULT_CORPUS, resident)
        self._serve = self._build_serve(
            self.budget.budget if self.budget else 2 * cfg.k)
        # Guards `stats` mutations so `stats_snapshot()` returns one
        # consistent view; held only around python dict updates — never
        # across dispatch or device work (the lock-free-producer
        # constraint applies to `manager.lock`, which this never nests
        # inside).
        self._stats_lock = threading.Lock()
        # EWMA serve latency: None until the first real batch collects —
        # `stats["ewma_latency_s"]` mirrors it (0.0 pre-seed, back-compat).
        self._ewma: float | None = None
        self.stats = {"queries": 0, "batches": 0, "wmd_reranks": 0,
                      "budget_rebuilds": 0, "budget_trajectory": [],
                      "tier_counts": [0] * 3, "degraded_batches": 0,
                      "tier_transitions": [],
                      "validation_failures": 0, "validation_retries": 0,
                      "poisoned_queries": 0, "deadline_misses": 0,
                      "worker_restarts": 0,
                      "stream_failures": 0, "dropped_queries": 0,
                      "corpus_switches": 0,
                      "ewma_latency_s": 0.0,
                      "cache": self.manager.stats}
        if self.budget is not None:
            self.stats["budget_trajectory"].append(self.budget.budget)
        self.controller: DegradationController | None = None
        if cfg.degradation:
            self.controller = DegradationController(
                shed_queue_depth=cfg.shed_queue_depth or 2 * cfg.max_batch,
                max_tier=cfg.max_tier, recover_after=cfg.recover_after,
                fail_streak_down=cfg.fail_streak_down, obs=self.obs)
            self.stats["tier_transitions"] = self.controller.transitions
        self._seq = 0
        # Diagnostic hook: set to a list to record ("dispatch"|"collect", seq)
        # events — the overlap tests assert dispatch(i+1) precedes collect(i).
        self.trace: list[tuple[str, int]] | None = None

    # -- stats (torn-read-safe) --------------------------------------------
    def bump(self, key: str, n: int = 1) -> int:
        """Increment one stats counter under the stats lock."""
        with self._stats_lock:
            v = self.stats[key] + n
            self.stats[key] = v
            return v

    def stats_snapshot(self) -> dict:
        """One CONSISTENT copy of ``stats``: every counter in the returned
        dict comes from the same instant (the live ``stats`` dict is
        mutated by the worker thread, so reading it field-by-field can
        tear).  Mutable members are copied so the snapshot never changes
        under the caller."""
        with self._stats_lock:
            snap = dict(self.stats)
            snap["budget_trajectory"] = list(snap["budget_trajectory"])
            snap["tier_counts"] = list(snap["tier_counts"])
            snap["tier_transitions"] = [dict(t)
                                        for t in snap["tier_transitions"]]
            snap["cache"] = dict(snap["cache"])
        return snap

    def metrics_snapshot(self) -> dict:
        """Full JSON-able telemetry export: server stats + metrics +
        events + tracer counters + process-wide sentinel state."""
        snap = self.obs.snapshot()
        snap["stats"] = self.stats_snapshot()
        return snap

    @property
    def ewma_latency(self) -> float | None:
        """Observed EWMA batch latency; None until the first real batch."""
        return self._ewma

    # -- active-corpus views -----------------------------------------------
    @property
    def engine(self) -> SegmentedEngine:
        return self._active.engine

    @property
    def budget(self) -> AdaptiveRefineBudget | None:
        return self._active.budget

    @property
    def _serve(self):
        st = self._active
        if st.serve is None:   # first use, or readmitted after eviction
            st.serve = self._build_serve(
                st.budget.budget if st.budget else 2 * self.cfg.k)
        return st.serve

    @_serve.setter
    def _serve(self, fn):
        self._active.serve = fn

    def _make_budget(self, engine) -> AdaptiveRefineBudget | None:
        cfg = self.cfg
        if cfg.rerank_wmd and cfg.adaptive_budget:
            return AdaptiveRefineBudget(
                k=cfg.k, n_resident=max(1, engine.n_live), init=2 * cfg.k,
                decay_after=cfg.budget_decay_after, obs=self.obs)
        return None

    def _make_index(self, engine):
        """Per-corpus ClusterIndex from ``cfg.index`` (an IndexConfig)."""
        icfg = self.cfg.index
        from repro_torch.index import ClusterIndex
        return ClusterIndex(
            engine, num_cells=min(icfg.num_cells, max(1, engine.n_docs)),
            seed=icfg.seed, top_p=icfg.top_p, bound_slack=icfg.bound_slack,
            probe_cap=icfg.probe_cap, method=icfg.method, obs=self.obs)

    def _build_serve(self, rerank_budget: int):
        # The segmented serve step is streaming-only: the serving path
        # always fuses selection (the reference's streaming_topk knob is
        # read by nothing here, so the port's config has none).
        cfg = self.cfg
        return build_serve_step(
            self.mesh, k=cfg.k, refine=cfg.refine_symmetric,
            bf16_matmul=False, engine=self.engine, rerank_wmd=cfg.rerank_wmd,
            rerank_budget=rerank_budget, wmd_kw=cfg.wmd_kw,
            streaming=True, obs=self.obs, index=self._active.index)

    def gather(self, values: Sequence[int]) -> list[list[int]]:
        """Every rank's ``values``, rank 0's first, by one ``all_gather``
        over the whole mesh (outside any serve step, so no step's
        collective gauges count it); ``[values]`` on a mesh of one rank or
        none.  Every rank passes as many values (none: no collective)."""
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return [[int(v) for v in values]]
        x = torch.tensor([[int(v) for v in values]], dtype=torch.int64,
                         device=mesh.device)
        return mesh.all_gather(x, mesh.axis_names).tolist()

    def agree(self, values: Sequence[int]) -> list[int]:
        """Rank 0's ``values`` on every rank (see :meth:`gather`)."""
        return self.gather(values)[0]

    def _activate(self, corpus_id: str | None) -> CorpusState:
        """Check out (readmitting if evicted) and make a corpus active."""
        st = self.manager.checkout(corpus_id or DEFAULT_CORPUS)
        if st is not self._active:
            self._active = st
            self.bump("corpus_switches")
        return st

    # -- corpus lifecycle (admissible between batches; manager-locked) -----
    def add_corpus(self, corpus_id: str, docs: DocSet,
                   vectorizer: Callable | None = None) -> None:
        self.manager.add_corpus(corpus_id, docs, vectorizer=vectorizer)

    def ingest(self, docs: DocSet, *, corpus_id: str | None = None,
               dedup_threshold: float | None = None):
        return self.manager.ingest(corpus_id or DEFAULT_CORPUS, docs,
                                   dedup_threshold=dedup_threshold)

    def delete_docs(self, doc_ids, *, corpus_id: str | None = None) -> int:
        return self.manager.delete_docs(corpus_id or DEFAULT_CORPUS, doc_ids)

    def compact(self, corpus_id: str | None = None) -> None:
        self.manager.compact(corpus_id or DEFAULT_CORPUS)

    def pad_batch(self, qs: Sequence[tuple[np.ndarray, np.ndarray]],
                  padded: tuple[np.ndarray, np.ndarray] | None = None
                  ) -> DocSet:
        """Host prep: the batch's histograms padded (or truncated) to
        ``h_max`` words by :func:`repro_torch.serving.staging.pad_batch`
        (the reference's rows bit for bit; idempotent), one row per real
        query, as a DocSet on the serving device.  ``padded``: those
        arrays, when the caller has padded them already.

        On the card the arrays go through pinned host memory with
        non-blocking copies, so the dispatch does not wait for the device;
        the pinned blocks are not reused before their copies complete (the
        caching host allocator records an event on each).
        """
        ids, w = padded or pad_batch(qs, len(qs), self.cfg.h_max)
        ids_t, w_t = torch.from_numpy(ids), torch.from_numpy(w)
        if self.device.type == "cuda":
            ids_t = ids_t.pin_memory().to(self.device, non_blocking=True)
            w_t = w_t.pin_memory().to(self.device, non_blocking=True)
        return DocSet(ids=ids_t, weights=w_t)

    def _readback(self, res: ServeResult):
        """Start copying a result's indices, dists and pruned_exact to the
        host: ``(host tensors, event)``.  On the card the copies go into
        fresh pinned buffers without blocking and ``event`` (recorded after
        them on the current stream) says when they are done; on the CPU
        the tensors are already host data and ``event`` is None."""
        parts = (res.topk.indices, res.topk.dists, res.pruned_exact)
        if not any(isinstance(t, torch.Tensor) and t.is_cuda for t in parts):
            return parts, None
        host = []
        for t in parts:
            if t is None:
                host.append(None)
                continue
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        ev = torch.cuda.Event()
        ev.record()
        return tuple(host), ev

    @staticmethod
    def _host_arrays(host, event) -> tuple:
        """Wait for a readback and return its numpy arrays (owned copies)."""
        if event is not None:
            event.synchronize()
        return tuple(None if t is None else t.numpy().copy() for t in host)

    def _raw_serve(self, qs: Sequence[tuple[np.ndarray, np.ndarray]],
                   tier: int, batch_seq: int | None,
                   btrace=None, t_prep0: float | None = None,
                   padded=None) -> ServeResult:
        """Pad + serve one chunk at `tier`, with fault hooks applied.

        The result stays on the device (kernels queued, not awaited).

        ``batch_seq=None`` marks a validation RETRY: dispatch-time faults
        (latency, crashes, transient NaNs) are skipped — only sticky
        query-keyed poison re-applies — so bisection converges.
        """
        t_pad0 = time.perf_counter()
        queries = self.pad_batch(qs, padded)
        if btrace is not None:
            # batch_formation covers ALL host prep of this batch: the
            # pipeline's vectorize/collect stage (from ``t_prep0``, when
            # the caller timed it) plus the pad — NOT just the pad.  The
            # prep half used to be misattributed to queue_wait, hiding
            # exactly the cost the ingest pool removes.
            btrace.span("batch_formation",
                        t_pad0 if t_prep0 is None else t_prep0,
                        time.perf_counter())
        if self.faults is not None and batch_seq is not None:
            self.faults.on_dispatch(batch_seq)
        # Tier 0 calls the step with its default signature so test spies /
        # wrappers that only accept (queries,) keep working.  The step's
        # own obs instrumentation records serve_step_host_seconds.
        if btrace is not None:
            btrace.begin("dispatch")
        res = self._serve(queries) if tier == 0 else \
            self._serve(queries, tier=tier)
        if btrace is not None:
            btrace.end("dispatch")
        if self.faults is not None:
            res = self.faults.poison_result(batch_seq, res, qs)
        return res

    def dispatch(self, qs: Sequence[tuple[np.ndarray, np.ndarray]], *,
                 queue_depth: int = 0,
                 corpus_id: str | None = None,
                 traces: Sequence = (),
                 t_dequeue: float | None = None,
                 t_prep0: float | None = None,
                 padded: tuple[np.ndarray, np.ndarray] | None = None
                 ) -> _InFlight:
        """Host-prep one ≤max_batch chunk and launch it on the device.

        Returns once the serve step's kernels and the copies of its
        results to pinned host buffers are queued, with a CUDA event behind
        them: the returned :class:`_InFlight` must be passed to
        :meth:`collect` to wait for and deliver the answers.  With degradation enabled the
        controller picks the tier from ``queue_depth`` pressure.

        The batch is served against ONE corpus (``corpus_id``, default
        corpus when None) — batching upstream never mixes corpora.  The
        manager lock is held across activation + serve-step launch so a
        concurrent ingest/delete/compact lands between batches, never
        mid-dispatch.

        ``t_dequeue``/``t_prep0`` let a pipelined caller pin the trace
        boundaries to when the batch actually LEFT the queue and when its
        host prep started: queue_wait ends at ``t_dequeue`` and
        batch_formation starts at ``t_prep0``, so preprocess time lands in
        batch_formation, not queue_wait.  Defaults (None) keep the
        lock-step behavior: both stamped here, at dispatch entry.
        ``padded``: the batch's arrays as :meth:`pad_batch` makes them, when
        the caller padded it already.
        """
        tier = 0
        if self.controller is not None:
            tier = self.controller.observe_dispatch(queue_depth)
        seq, self._seq = self._seq, self._seq + 1
        if self.trace is not None:
            self.trace.append(("dispatch", seq))
        if t_dequeue is None:
            t_dequeue = time.perf_counter()
        bt = self.obs.tracer.batch(seq)
        if bt is not None:
            bt.tier = tier
            for tr in traces:
                if tr is not None:
                    tr.joined_batch(bt, t_dequeue)
        t0 = time.perf_counter()
        with self.manager.lock:
            state = self._activate(corpus_id)
            res = self._raw_serve(qs, tier, seq, btrace=bt, t_prep0=t_prep0,
                                  padded=padded)
            host, event = self._readback(res)
        if bt is not None:
            # Device span: opens when the queued step returns, closes when
            # collect's wait on the batch's event returns.
            bt.begin("device_compute")
        with self._stats_lock:
            self.stats["queries"] += len(qs)
            self.stats["batches"] += 1
            self.stats["tier_counts"][min(tier, 2)] += 1
            if tier:
                self.stats["degraded_batches"] += 1
            if self.cfg.rerank_wmd and tier == 0:
                self.stats["wmd_reranks"] += len(qs)
        if self.obs.metrics.enabled:
            self._m_queries.inc(len(qs))
            self._m_batches.inc()
            self._m_batch_size.observe(len(qs))
            self._m_queue_depth.set(queue_depth)
            self._m_dispatch.observe(time.perf_counter() - t0)
            for tr in traces:
                if tr is not None:
                    self._m_queue_wait.observe(t_dequeue - tr.t_admit)
        return _InFlight(result=res, n_real=len(qs), seq=seq,
                         qs=tuple(qs), tier=tier, t0=t0, state=state,
                         traces=tuple(traces), btrace=bt, host=host,
                         event=event)

    def collect(self, inflight: _InFlight) -> list:
        """Wait for one dispatched batch; validate + deliver answers.

        This is where the host waits for the device: on the batch's CUDA
        event, after which the pinned host copies hold its results.
        Non-finite distances divert to the bisection quarantine path
        (:meth:`_validated_answers`); clean batches feed the adaptive
        budget, whose change rebuilds the serve step — ONCE, here at
        collect time, regardless of any tier changes in the same flush
        (tier switches never rebuild: the tier is a dispatch argument of
        the one step).  In the async
        pipeline, at most ``pipeline_depth - 1`` already-dispatched batches
        still use the previous budget — the trajectory in ``stats`` is the
        ground truth either way.

        Returns one entry per real query, in order: an :class:`Answer` or
        a :class:`ServingError` instance (quarantined poison).
        """
        res, n_real, tier = inflight.result, inflight.n_real, inflight.tier
        bt = inflight.btrace
        if inflight.state is not None:
            # Budget feedback, rebuilds, and validation retries must hit the
            # corpus this batch was served against, not whichever corpus a
            # later pipelined dispatch activated.
            self._active = inflight.state
        t_read0 = time.perf_counter()
        tk_i, tk_d, exact = self._host_arrays(inflight.host, inflight.event)
        if bt is not None:
            bt.end("device_compute")
        if self.obs.metrics.enabled:
            self._m_collect.observe(time.perf_counter() - t_read0)
        if self.trace is not None:
            self.trace.append(("collect", inflight.seq))
        if bt is not None:
            bt.begin("validation")
        finite = np.isfinite(tk_d[:n_real]).all(axis=1)
        if self.cfg.validate_results and not finite.all():
            answers = self._validated_answers(inflight, tk_i, tk_d, finite)
        else:
            if self.controller is not None:
                self.controller.note_success()
            if self.budget is not None and exact is not None and tier == 0:
                old = self.budget.budget
                new = self.budget.update(exact[:n_real])
                if new != old:
                    # A budget change legitimately builds a new serve
                    # step — tell the armed sentinel so.
                    with sentinel.expect("adaptive budget rebuild"):
                        self._serve = self._build_serve(new)
                    with self._stats_lock:
                        self.stats["budget_rebuilds"] += 1
                        self.stats["budget_trajectory"].append(new)
                    self.obs.events.append(BudgetRebuild(
                        corpus_id=self._active.corpus_id,
                        old_budget=old, new_budget=new))
                    self._m_budget.set(new)
            answers = [Answer(tk_i[j], tk_d[j], tier=tier)
                       for j in range(n_real)]
        if bt is not None:
            bt.end("validation")
        if inflight.t0:
            dt = time.perf_counter() - inflight.t0
            prev = self._ewma
            self._ewma = dt if prev is None else 0.8 * prev + 0.2 * dt
            with self._stats_lock:
                self.stats["ewma_latency_s"] = self._ewma
            if self.obs.metrics.enabled:
                self._m_e2e.observe(dt)
                self._m_ewma.set(self._ewma)
        # Attach completed traces: batch-mates share `bt`; each healthy
        # answer (or per-query error) carries its own QueryTrace.
        if inflight.traces:
            for j, tr in enumerate(inflight.traces):
                if tr is None or j >= len(answers):
                    continue
                tr.finish()
                ans = answers[j]
                if ans is not None:
                    try:
                        ans.trace = tr
                    except (AttributeError, TypeError):
                        pass  # exotic answer type without a __dict__
        return answers

    def _validated_answers(self, inflight: _InFlight, tk_i, tk_d,
                           finite) -> list:
        """Bisection quarantine: recover every healthy query of a batch
        whose device result came back non-finite.

        The finite rows keep their original answers.  The non-finite rows
        are re-served (``batch_seq=None`` — transient faults don't
        re-apply); rows that stay bad are split and recursed until a
        singleton stays bad, which is quarantined with a per-query
        :class:`PoisonQuery`.  Cost: O(p · log max_batch) extra serves for
        p poison queries — never fails the other ``max_batch - p``.
        """
        n_real, tier = inflight.n_real, inflight.tier
        self.bump("validation_failures")
        if self.controller is not None:
            self.controller.note_stage_failure()
        out: list = [None] * n_real
        for j in range(n_real):
            if finite[j]:
                out[j] = Answer(tk_i[j], tk_d[j], tier=tier)

        def solve(idx: list[int]) -> None:
            res = self._raw_serve([inflight.qs[i] for i in idx], tier, None)
            self.bump("validation_retries")
            i_, d, _ = self._host_arrays(*self._readback(res))
            ok = np.isfinite(d[:len(idx)]).all(axis=1)
            bad = []
            for j, q in enumerate(idx):
                if ok[j]:
                    out[q] = Answer(i_[j], d[j], tier=tier)
                else:
                    bad.append(q)
            if not bad:
                return
            if len(idx) == 1:
                q = idx[0]
                self.bump("poisoned_queries")
                self.obs.events.append(QueryQuarantined(
                    batch_seq=inflight.seq, slot=q))
                out[q] = PoisonQuery(
                    f"non-finite distances isolated to one query by "
                    f"bisection (batch #{inflight.seq}, slot {q})")
                return
            mid = (len(bad) + 1) // 2
            solve(bad[:mid])
            solve(bad[mid:])

        solve([j for j in range(n_real) if not finite[j]])
        return out


class QueryServer:
    """Synchronous reference server.

    A thin lock-step wrapper over the shared :class:`_ServeCore`: every
    flush chunk is ``dispatch`` immediately followed by ``collect``, so
    results are in hand when :meth:`flush` returns.  Use
    :class:`AsyncQueryServer` for the pipelined variant; both produce
    identical answers for identical inputs.

    ``submit`` screens queries (:class:`PoisonQuery` for zero-mass
    histograms, :class:`QueryRejected` for already-expired deadlines);
    ``flush`` delivers a :class:`DeadlineExceeded` instance POSITIONALLY
    for any query whose deadline lapsed while pending (never raises for
    it — batch-mates keep their answers).

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`): serve through the
    mesh program, on the mesh's device (a ``cfg.device`` that is not it
    raises ``ValueError``).  Every rank builds the server alike, submits
    the same queries and calls ``flush`` / ``serve_stream`` alike; the
    lapsed deadlines, the queue depth that picks the tier and the stream's
    flushes are rank 0's, and every rank gets the same answers.  Corpus
    changes (``add_corpus``, ``ingest``, ``delete_docs``, ``compact``, and
    so the evictions that follow from them) are the caller's to make at
    the same point on every rank.
    """

    def __init__(self, resident: DocSet, emb, cfg: ServerConfig,
                 *, mesh=None,
                 preprocess: Callable[[QueryLike],
                                      tuple[np.ndarray, np.ndarray]] | None = None,
                 faults=None):
        self._core = _ServeCore(resident, emb, cfg, faults=faults, mesh=mesh)
        self._preprocess = preprocess
        # Pending entries:
        # (ids, weights, absolute deadline|None, corpus_id, QueryTrace|None).
        self._pending: list[
            tuple[np.ndarray, np.ndarray, float | None, str, Any]] = []

    # -- shared-core views (kept as attributes of record for tests/tools) --
    @property
    def resident(self) -> DocSet:
        return self._core.resident

    @property
    def emb(self):
        return self._core.emb

    @property
    def cfg(self) -> ServerConfig:
        return self._core.cfg

    @property
    def engine(self) -> SegmentedEngine:
        return self._core.engine

    @property
    def budget(self) -> AdaptiveRefineBudget | None:
        return self._core.budget

    @property
    def stats(self) -> dict:
        return self._core.stats

    @property
    def obs(self):
        """This server's :class:`repro_torch.obs.Observability` bundle."""
        return self._core.obs

    def stats_snapshot(self) -> dict:
        """One consistent copy of ``stats`` (see `_ServeCore.stats_snapshot`)."""
        return self._core.stats_snapshot()

    def metrics_snapshot(self) -> dict:
        """JSON-able telemetry: stats + metrics + events + sentinel."""
        return self._core.metrics_snapshot()

    @property
    def _serve(self):
        """The serve-step callable (swappable, e.g. by test spies)."""
        return self._core._serve

    @_serve.setter
    def _serve(self, fn):
        self._core._serve = fn

    def _build_serve(self, rerank_budget: int):
        return self._core._build_serve(rerank_budget)

    # -- corpus lifecycle --------------------------------------------------
    def add_corpus(self, corpus_id: str, docs: DocSet,
                   vectorizer: Callable | None = None) -> None:
        """Admit a new tenant corpus under ``corpus_id``.

        ``vectorizer`` (optional) becomes this corpus's query preprocess
        hook for raw-payload submissions."""
        self._core.add_corpus(corpus_id, docs, vectorizer=vectorizer)

    def ingest(self, docs: DocSet, *, corpus_id: str | None = None,
               dedup_threshold: float | None = None):
        """Append docs to a corpus as one delta segment (O(delta) build).

        Returns ``(global_ids, admitted_mask)``; with a dedup threshold
        (explicit or ``cfg.dedup_threshold``) near-duplicates of live docs
        are gated out first.  Admissible between batches — no rebuild.
        """
        return self._core.ingest(docs, corpus_id=corpus_id,
                                 dedup_threshold=dedup_threshold)

    def delete_docs(self, doc_ids, *, corpus_id: str | None = None) -> int:
        """Tombstone global doc ids; dead docs never appear in answers."""
        return self._core.delete_docs(doc_ids, corpus_id=corpus_id)

    def compact(self, corpus_id: str | None = None) -> None:
        """Merge delta segments into one base segment (stable global ids)."""
        self._core.compact(corpus_id)

    # -- request path ------------------------------------------------------
    def submit(self, ids, weights=None, *, deadline: float | None = None,
               corpus_id: str | None = None):
        """Queue one query histogram (padded to h_max by the caller/vectorizer).

        With a ``preprocess`` hook installed, a single raw payload may be
        submitted instead; the hook runs HERE, on the caller's thread (the
        async server defers it to the pipeline's host-prep stage).

        ``deadline`` is a relative budget in seconds; an already-expired
        deadline raises :class:`QueryRejected` (with admission control), a
        zero-mass histogram raises :class:`PoisonQuery`.  ``corpus_id``
        routes the query to a tenant corpus (default corpus when None); an
        unknown id raises :class:`QueryRejected` at submit.
        """
        if self._preprocess is not None and weights is None:
            vec = (self._core.manager.vectorizer_for(corpus_id)
                   if corpus_id else None) or self._preprocess
            try:
                ids, weights = vec(ids)
            except ServingError:
                raise
            except Exception as e:
                raise PoisonQuery(f"preprocess failed: {e}") from e
        elif weights is None:
            raise ValueError(
                "submit(ids, weights) needs explicit weights unless a "
                "preprocess hook is installed (raw-payload submission)")
        _check_query(ids, weights)
        cid = corpus_id or DEFAULT_CORPUS
        if not self._core.manager.has_corpus(cid):
            raise QueryRejected(f"unknown corpus {cid!r}")
        abs_deadline = None
        if deadline is not None:
            abs_deadline = time.monotonic() + float(deadline)
            if self.cfg.admission_control and float(deadline) <= 0:
                raise QueryRejected(
                    f"deadline {deadline!r}s already expired at submit")
        self._pending.append((ids, weights, abs_deadline, cid,
                              self._core.obs.tracer.admit()))

    def _flush_chunk(self, qs: list, corpus_id: str):
        """Serve one ≤max_batch same-corpus chunk (its real queries only).

        Expired entries are not dispatched; their slots carry a
        :class:`DeadlineExceeded` instance in the returned list.
        """
        now = time.monotonic()
        depth, *lapsed = self._core.agree(
            [len(self._pending)]
            + [q[2] is not None and q[2] <= now for q in qs])
        live = [j for j, x in enumerate(lapsed) if not x]
        dead = [j for j, x in enumerate(lapsed) if x]
        out: list = [None] * len(qs)
        for j in dead:
            self._core.bump("deadline_misses")
            if self._core.controller is not None:
                self._core.controller.note_deadline_miss()
            err = DeadlineExceeded(
                "deadline expired before the batch was dispatched")
            tr = qs[j][4]
            if tr is not None:
                tr.finish()
                err.trace = tr
            out[j] = err
        if live:
            answers = self._core.collect(
                self._core.dispatch([qs[j][:2] for j in live],
                                    queue_depth=depth,
                                    corpus_id=corpus_id,
                                    traces=[qs[j][4] for j in live]))
            for j, a in zip(live, answers):
                out[j] = a
        return out

    def flush(self):
        """Serve everything pending; returns list of (doc_ids, distances).

        Pending queries are chunked into serve calls of at most
        ``max_batch`` queries.  A chunk never mixes corpora: contiguous runs of the
        same ``corpus_id`` dispatch together, preserving positional answer
        order.  Entries may be typed :class:`ServingError` instances
        (expired deadline, quarantined poison) — positionally, so
        batch-mates are never lost.
        """
        qs, self._pending = self._pending, []
        out = []
        lo = 0
        while lo < len(qs):
            hi = lo + 1
            while (hi < len(qs) and hi - lo < self.cfg.max_batch
                   and qs[hi][3] == qs[lo][3]):
                hi += 1
            out.extend(self._flush_chunk(qs[lo:hi], qs[lo][3]))
            lo = hi
        return out

    def serve_stream(self, stream):
        """Batched streaming: yields answers in arrival order.

        The staleness clock starts when the FIRST query of a batch arrives
        (not at the previous flush), so a steady trickle fills batches
        instead of flushing them nearly empty.

        If the INPUT stream raises mid-iteration, queries queued before the
        failure are still flushed and their answers yielded before the
        exception propagates — a dying producer never loses accepted work.
        ``stats["stream_failures"]`` counts dying producers; if the
        post-mortem flush itself fails, ``stats["dropped_queries"]`` counts
        the accepted-but-never-answered queries (operator visibility).
        """
        # Arrival time of the oldest pending query; queries already pending
        # when the stream starts inherit the stream start as their clock.
        t0 = time.perf_counter() if self._pending else None
        it = iter(stream)
        while True:
            try:
                q = next(it)
            except StopIteration:
                break
            except Exception:
                # Producer died: drain what was accepted, then re-raise.
                # (Exception, not BaseException: a KeyboardInterrupt must
                # propagate immediately, not run device flushes first.)
                self._core.bump("stream_failures")
                n_at_risk = len(self._pending)
                try:
                    yield from self.flush()
                except Exception:
                    self._core.bump("dropped_queries", n_at_risk)
                    raise
                raise
            if not self._pending:
                t0 = time.perf_counter()
            if self._preprocess is None:
                self.submit(*q)          # (ids, weights) pairs, as ever
            else:
                self.submit(q)           # raw payloads go through the hook
            full = len(self._pending) >= self.cfg.max_batch
            stale = (
                t0 is not None
                and (time.perf_counter() - t0) > self.cfg.max_wait_s
            )
            if self._core.agree([full or stale])[0]:
                yield from self.flush()
                t0 = None
        yield from self.flush()


class AsyncQueryServer:
    """Async double-buffered serving pipeline over the shared core.

    ``submit`` enqueues one query and returns a :class:`ServeFuture`
    immediately.  A single worker thread drives a two-stage pipeline:

      1. HOST stage — gather up to ``max_batch`` pending queries (waiting at
         most ``max_wait_s`` from the batch's first arrival, rushing early
         when the earliest pending deadline approaches), run the optional
         ``preprocess`` hook, pad each to ``h_max`` words, and DISPATCH (the
         serve step's kernels and the result copies are queued on the
         stream, a CUDA event behind them; nothing waits for the device).
      2. DEVICE stage — up to ``cfg.pipeline_depth`` (default 2: double
         buffering) dispatched batches stay in flight; the oldest is
         collected (a wait on its event) only once the window is full, no
         new work is pending, or its event reports it done.

    Because dispatch does not wait, step 1 for batch *i+1* runs on the host
    WHILE batch *i* executes on the device.  Futures resolve strictly in submission order (FIFO batching, FIFO
    collection).

    Backpressure: at most ``cfg.queue_capacity`` (default ``4·max_batch``)
    queries may be pending; ``submit`` blocks the producer until the worker
    drains below capacity (bounded memory under overload).  A deadline
    bounds the wait: if the queue is still full when the query's deadline
    arrives, ``submit`` raises :class:`QueryRejected` instead of blocking
    past the point the answer could matter.

    Fault tolerance: the worker loop runs under a SUPERVISOR — any
    worker-thread death fails that batch's in-flight futures with
    :class:`WorkerCrashed` and restarts the loop (queued requests keep
    submission order); after ``cfg.max_worker_restarts`` consecutive
    crashes the server closes itself and fails everything unresolved with
    :class:`ServerClosed`.  A CUDA error that leaves the context unusable
    is not restarted: its batch fails with :class:`WorkerCrashed` and the
    server closes, failing everything else with :class:`ServerClosed`.
    :meth:`health` snapshots liveness, queue depth,
    in-flight futures, degradation tier, and the error counters.  No
    accepted future is ever left unresolved.

    Lifecycle: use as a context manager, or call :meth:`close` —
    idempotent, safe to race with ``submit``, and with ``timeout=`` it
    force-fails whatever a wedged worker never answered.  ``drain`` blocks
    until every accepted query has been answered.

    ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`): serve through the
    mesh program on the mesh's device.  On a mesh of one rank the server is
    the mesh-less one bit for bit (the worker's loop is the same on every
    rank count; on one rank it issues no collective).  Over more ranks,
    every rank builds the server alike and makes the same ``submit`` and corpus-change calls in
    the same order; each rank's worker then runs the same pipeline steps:

    * Rank 0's worker decides each step by its own clock and queue, as the
      mesh-less worker does, and one fixed-length ``all_gather`` shares
      the decision before any rank acts on it: the corpus changes to apply
      first, the queued entries that lapsed or that rank 0's admission
      check rejected (their positions follow in a second ``all_gather`` at
      the length the first gives), how many entries leave the queue head
      as the next batch and the queue depth that picks its tier, or a
      collect of the oldest batch in flight, or the exit.  A follower's
      clock decides nothing: it waits until its own queue holds the
      entries named, then takes exactly those.
    * Each rank prepares the batch (its own ingest pool or thread
      vectorizes its own raw payloads; no row crosses ranks) and one more
      ``all_gather`` compares the ranks' digests of the padded ids and
      weights with rank 0's: a batch that differs anywhere fails on every
      rank with :class:`MeshDivergence`, and no rank serves it.
    * At delivery, which answers arrived past their deadline (and the
      latency average the next decisions read) are rank 0's, shared the
      same way, so tiers, errors and ``stats`` are the same on every rank.
    * A ``submit`` whose deadline runs out at admission (already expired,
      or the queue still full at its deadline) is queued anyway; it fails
      through its future with :class:`QueryRejected` if rank 0's decision
      says rank 0 rejected it.
    * ``add_corpus``, ``ingest``, ``delete_docs`` and ``compact`` queue a
      numbered change and block until the worker has applied it at the
      batch boundary rank 0 named; they return what they return on one
      rank.
    * While the server runs it owns the mesh's groups: only its worker
      thread issues collectives (the steps', the decisions', any under a
      dedup ingest), so the caller must issue none until ``close``
      returns.  Rank 0 sends an empty decision after a second idle.
    * Planned faults keep the ranks in step: a ``FaultPlan``'s batch
      numbers name agreed batches, so a planned crash hits every rank at
      the same batch and every supervisor restarts alike.  A crash on one
      rank alone (a process, a card or a vectorizer that fails on one
      rank) is not handled: the other ranks wait in a collective until
      the group's timeout.
    """

    def __init__(self, resident: DocSet, emb, cfg: ServerConfig,
                 *, mesh=None,
                 preprocess: Callable[[QueryLike],
                                      tuple[np.ndarray, np.ndarray]] | None = None,
                 faults=None):
        self._core = _ServeCore(resident, emb, cfg, faults=faults, mesh=mesh)
        # Over more than one rank rank 0's worker decides for every rank.
        self._ranks = 1 if mesh is None else mesh.size
        self._lead = self._ranks == 1 or mesh.rank == 0
        self._preprocess = preprocess
        self._capacity = cfg.queue_capacity or 4 * cfg.max_batch
        self._depth = max(1, cfg.pipeline_depth)
        # Multi-process host plane: raw payloads vectorize in spawned
        # worker processes; the dispatcher reads histograms zero-copy from
        # the staging ring.  Direct (ids, weights) submissions bypass it.
        self._pool = None
        if cfg.ingest_workers > 0:
            if preprocess is None:
                raise ValueError(
                    "ServerConfig(ingest_workers>0) needs a preprocess "
                    "hook — the pool exists to parallelize raw-payload "
                    "vectorization (and it must be spawn-picklable)")
            from repro_torch.serving.ingest_pool import IngestPool
            self._pool = IngestPool(
                cfg.ingest_workers, cfg.h_max,
                slots=cfg.staging_slots or 4 * cfg.max_batch,
                default_preprocess=preprocess,
                vectorizers=self._core.manager.vectorizers,
                faults_plan=(self._core.faults.plan
                             if self._core.faults is not None else None),
                max_restarts=cfg.max_worker_restarts,
                timeout_s=cfg.ingest_timeout_s, obs=self._core.obs)
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)   # submit backpressure
        self._work = threading.Condition(self._lock)       # worker wake-up
        self._idle = threading.Condition(self._lock)       # drain wait
        # Queue entries: (payload, future, absolute monotonic deadline|None,
        # corpus_id, QueryTrace|None).
        self._queue: deque[
            tuple[QueryLike, ServeFuture, float | None, str, Any]] = deque()
        self._inflight: deque = deque()  # (_InFlight, futures, deadlines)
        self._batch_t0: float | None = None  # arrival of oldest pending query
        self._flush_requested = False
        self._closed = False
        self._n_unanswered = 0  # accepted (queued or in flight), not resolved
        self._prep_idx = 0      # submission-order index fed to fault hooks
        # Over more than one rank: corpus changes waiting for the worker
        # (callable, its future), and the entries this rank's admission
        # check rejected (read on rank 0 only).
        self._changes: deque = deque()
        self._rejects: dict = {}
        self._starved = False   # a follower's worker waits for entries
        # Futures of the batch currently inside dispatch()/collect() on the
        # worker thread: a crash there escapes before they reach (or after
        # they left) `_inflight`, so the supervisor must fail them from
        # here — otherwise they would hang forever.
        self._crash_victims: list[ServeFuture] = []
        self._worker = threading.Thread(
            target=self._supervised_run, name="lcrwmd-serve-pipeline",
            daemon=True)
        self._worker.start()

    # -- shared-core views -------------------------------------------------
    @property
    def cfg(self) -> ServerConfig:
        return self._core.cfg

    @property
    def engine(self) -> SegmentedEngine:
        return self._core.engine

    @property
    def budget(self) -> AdaptiveRefineBudget | None:
        return self._core.budget

    @property
    def stats(self) -> dict:
        return self._core.stats

    @property
    def obs(self):
        """This server's :class:`repro_torch.obs.Observability` bundle."""
        return self._core.obs

    def stats_snapshot(self) -> dict:
        """One consistent copy of ``stats`` (see `_ServeCore.stats_snapshot`)."""
        return self._core.stats_snapshot()

    def metrics_snapshot(self) -> dict:
        """JSON-able telemetry: stats + metrics + events + sentinel."""
        return self._core.metrics_snapshot()

    @property
    def _serve(self):
        return self._core._serve

    @_serve.setter
    def _serve(self, fn):
        self._core._serve = fn

    # -- corpus lifecycle (admissible between batches) ---------------------
    def add_corpus(self, corpus_id: str, docs: DocSet,
                   vectorizer: Callable | None = None) -> None:
        """Admit a new tenant corpus under ``corpus_id``.

        ``vectorizer`` (optional, picklable) becomes this corpus's query
        preprocess hook; with an ingest pool it is installed on every
        worker process so raw payloads for this tenant vectorize against
        the right vocabulary.
        """
        self._change(lambda: self._core.add_corpus(corpus_id, docs,
                                                   vectorizer=vectorizer))
        if self._pool is not None and vectorizer is not None:
            self._pool.add_vectorizer(corpus_id, vectorizer)

    def ingest(self, docs: DocSet, *, corpus_id: str | None = None,
               dedup_threshold: float | None = None):
        """Append docs as one delta segment; returns (gids, admitted).

        Safe to call while the pipeline is serving: the manager lock
        serializes it against dispatch, so it lands BETWEEN batches, and
        the serve step picks the new segment up on its next call (no
        rebuild).  Its CUDA work is issued on this thread's current stream,
        the default stream the serve loop uses too.  Over more than one
        rank the worker applies it, at the boundary rank 0 names.
        """
        return self._change(lambda: self._core.ingest(
            docs, corpus_id=corpus_id, dedup_threshold=dedup_threshold))

    def delete_docs(self, doc_ids, *, corpus_id: str | None = None) -> int:
        """Tombstone global doc ids; dead docs never appear in answers."""
        return self._change(lambda: self._core.delete_docs(
            doc_ids, corpus_id=corpus_id))

    def compact(self, corpus_id: str | None = None) -> None:
        """Merge delta segments into one base segment (stable ids)."""
        self._change(lambda: self._core.compact(corpus_id))

    def _change(self, fn: Callable):
        """Run a corpus change here, or over more than one rank queue it for
        the worker and wait until it is applied; returns its result."""
        if self._ranks == 1:
            return fn()
        done: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            if self._closed:
                raise ServerClosed("corpus change on a closed AsyncQueryServer")
            self._changes.append((fn, done))
            self._work.notify_all()
        return done.result()

    # -- producer API ------------------------------------------------------
    def submit(self, ids, weights=None, *, deadline: float | None = None,
               corpus_id: str | None = None) -> ServeFuture:
        """Enqueue one query; returns its :class:`ServeFuture` immediately.

        Accepts either ``(ids, weights)`` numpy histograms or — with a
        ``preprocess`` hook installed — a single raw payload, which the
        WORKER thread vectorizes inside the pipeline's host stage (so raw
        ingest overlaps device compute).  Blocks while the pending queue is
        at ``queue_capacity``.

        ``deadline`` is a relative budget in seconds, converted to an
        absolute monotonic deadline at submit.  Admission control
        (``cfg.admission_control``) raises :class:`QueryRejected` when the
        deadline is already expired or passes while waiting for queue
        capacity; zero-mass histograms raise :class:`PoisonQuery`; a closed
        server raises :class:`ServerClosed` (a ``RuntimeError``).
        ``corpus_id`` routes the query to a tenant corpus (default corpus
        when None); an unknown id raises :class:`QueryRejected` at submit.
        """
        if self._preprocess is None and weights is None:
            raise ValueError(
                "submit(ids, weights) needs explicit weights unless a "
                "preprocess hook is installed (raw-payload submission)")
        cid = corpus_id or DEFAULT_CORPUS
        if not self._core.manager.has_corpus(cid):
            raise QueryRejected(f"unknown corpus {cid!r}")
        abs_deadline = None
        if deadline is not None:
            abs_deadline = time.monotonic() + float(deadline)
        payload: QueryLike = (ids, weights)
        fut = ServeFuture()
        tr = self._core.obs.tracer.admit()
        with self._lock:
            if self._closed:
                raise ServerClosed("submit() on a closed AsyncQueryServer")
            if self._preprocess is None:
                _check_query(ids, weights)
            # Over more than one rank an admission check that reads the
            # clock queues the entry anyway: rank 0's decision rejects it
            # on every rank, or on none.
            reject = None
            if (abs_deadline is not None and self.cfg.admission_control
                    and abs_deadline <= time.monotonic()):
                reject = f"deadline {deadline!r}s already expired at submit"
                if self._ranks == 1:
                    raise QueryRejected(reject)
            while (reject is None and len(self._queue) >= self._capacity
                   and not self._closed and not self._starved):
                if abs_deadline is not None and self.cfg.admission_control:
                    slack = abs_deadline - time.monotonic()
                    if slack <= 0:
                        reject = ("pending queue still at capacity when the "
                                  "query's deadline arrived")
                        if self._ranks == 1:
                            raise QueryRejected(reject)
                        break
                    self._not_full.wait(slack)
                else:
                    self._not_full.wait()
            if self._closed:
                raise ServerClosed("submit() on a closed AsyncQueryServer")
            if self._pool is not None and weights is None:
                # Raw payload with an ingest pool: hand it to a worker
                # process NOW (the ticket is assigned under this lock, so
                # queue order == ticket order == collection order) and
                # queue only the ticket marker — the histogram itself
                # comes back through the staging ring, never pickled.
                payload = _Staged(self._pool.submit(ids, cid))
            if not self._queue:
                self._batch_t0 = time.perf_counter()
            if reject is not None:
                self._rejects[fut] = reject
            self._queue.append((payload, fut, abs_deadline, cid, tr))
            self._n_unanswered += 1
            self._work.notify_all()
        return fut

    def flush(self) -> None:
        """Ask the pipeline to dispatch the current partial batch now
        (instead of waiting for ``max_batch`` fill or ``max_wait_s``)."""
        with self._lock:
            self._flush_requested = True
            self._work.notify_all()

    def drain(self) -> None:
        """Block until every accepted query has been answered."""
        with self._lock:
            self._flush_requested = True
            self._work.notify_all()
            while self._n_unanswered > 0:
                self._idle.wait(0.1)
                self._flush_requested = True
                self._work.notify_all()
            # Everything answered: a leftover flush request must not make
            # the next submission dispatch as a near-empty batch.
            self._flush_requested = False

    def close(self, timeout: float | None = None) -> None:
        """Stop accepting work, serve what was accepted, stop the worker.

        Idempotent and safe to race with ``submit`` (late submitters get
        :class:`ServerClosed`).  The worker drains the remaining queue
        before exiting, so accepted futures still resolve with answers.
        With ``timeout=`` the join is bounded: if the worker is wedged past
        it, every still-unresolved future is failed with
        :class:`ServerClosed` so no caller blocks forever.
        """
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._not_full.notify_all()
            self._idle.notify_all()
        self._worker.join(timeout)
        if self._worker.is_alive():
            self._fail_unresolved(ServerClosed(
                f"close(timeout={timeout}) expired with the worker wedged; "
                "unresolved futures failed"))
        else:
            # Worker exited cleanly; sweep any straggler that raced in.
            self._fail_unresolved(ServerClosed("server closed"))
        if self._pool is not None:
            self._pool.close()

    def health(self) -> dict:
        """Liveness/pressure snapshot for operators and supervisors.

        Every stats-derived field comes from ONE consistent
        ``stats_snapshot()`` — the worker mutates the live dict while this
        runs, so field-by-field reads of ``self.stats`` can tear.  The
        ``metrics`` key carries the latest registry snapshot (empty dict
        when metrics are disabled).
        """
        s = self._core.stats_snapshot()
        m = self._core.obs.metrics
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "in_flight": sum(len(f) for _h, f, _d in self._inflight),
                "unanswered": self._n_unanswered,
                "worker_alive": self._worker.is_alive(),
                "closed": self._closed,
                "tier": (self._core.controller.tier
                         if self._core.controller else 0),
                "worker_restarts": s["worker_restarts"],
                "deadline_misses": s["deadline_misses"],
                "poisoned_queries": s["poisoned_queries"],
                "validation_failures": s["validation_failures"],
                "queries": s["queries"],
                "batches": s["batches"],
                "ewma_latency_s": s["ewma_latency_s"],
                "corpus_switches": s["corpus_switches"],
                "cache": self._core.manager.snapshot(),
                "ingest_pool": (self._pool.snapshot()
                                if self._pool is not None else None),
                "metrics": m.snapshot() if m.enabled else {},
            }

    def __enter__(self) -> "AsyncQueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- pipeline (worker thread) ------------------------------------------
    def _prep(self, payload: QueryLike,
              corpus_id: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        ids, w = payload
        if self._preprocess is not None and w is None:
            vec = (self._core.manager.vectorizer_for(corpus_id)
                   if corpus_id else None) or self._preprocess
            ids, w = vec(ids)
            _check_query(ids, w)  # hook output screened like direct submits
        return ids, w

    def _rush_margin(self) -> float:
        """How early (seconds) to dispatch ahead of the earliest pending
        deadline: the observed serve latency, floored at 1 ms.

        Until the FIRST real batch seeds the EWMA there is no latency
        observation at all — a cold 0.0 would mean "dispatch with 1 ms to
        spare", which a first (compile-including) batch can never make.
        Pre-seed, assume one full batching window (``max_wait_s``) so
        early deadline-carrying queries rush conservatively; post-seed the
        margin tracks measured latency (exported as the
        ``serving_ewma_latency_seconds`` gauge, so every rush decision is
        explainable from a snapshot).
        """
        ewma = self._core.ewma_latency
        if ewma is None:
            return max(0.001, float(self._core.cfg.max_wait_s))
        return max(0.001, float(ewma))

    def _batch_due_locked(self, now: float) -> float | None:
        """None when the queued entries make a batch now (``max_batch``
        queued, the oldest past ``max_wait_s``, the earliest deadline one
        serve latency away, a flush, or closing); else how long to wait
        for that.  Lock held, queue non-empty."""
        cfg = self._core.cfg
        mono = time.monotonic()
        stale = (self._batch_t0 is not None
                 and now - self._batch_t0 >= cfg.max_wait_s)
        dls = [d for _p, _f, d, _c, _t in self._queue if d is not None]
        # Rush: dispatch the partial batch early when the earliest
        # deadline is one serve-latency away.
        rush = bool(dls) and (min(dls) - mono <= self._rush_margin())
        if (len(self._queue) >= cfg.max_batch or stale or rush
                or self._flush_requested or self._closed):
            return None
        timeout = max(0.0, self._batch_t0 + cfg.max_wait_s - now)
        if dls:
            timeout = min(timeout, max(
                0.0, min(dls) - mono - self._rush_margin()))
        return timeout

    def _head_run_locked(self) -> int:
        """Entries in the next batch: the longest same-corpus run at the
        queue head, at most ``max_batch``.  Lock held."""
        take = min(len(self._queue), self._core.cfg.max_batch)
        cid = self._queue[0][3]
        n = 1
        while n < take and self._queue[n][3] == cid:
            n += 1
        return n

    def _pop_batch_locked(self, n: int, now: float) -> list:
        """Take the ``n`` entries at the queue head.  Lock held."""
        items = [self._queue.popleft() for _ in range(n)]
        if self._queue:
            # Remaining queries start a fresh staleness clock.
            self._batch_t0 = now
        else:
            self._batch_t0 = None
            self._flush_requested = False
        self._not_full.notify_all()
        return items

    def _resolve(self, futures: Sequence[ServeFuture],
                 answers: Sequence) -> None:
        """Deliver one entry per future: an Answer or an exception."""
        try:
            for fut, ans in zip(futures, answers):
                try:
                    tr = getattr(ans, "trace", None)
                    if tr is not None:
                        fut.trace = tr
                    if isinstance(ans, BaseException):
                        fut.set_exception(ans)
                    else:
                        fut.set_result(ans)
                except concurrent.futures.InvalidStateError:
                    # The client cancelled this future; its query was served
                    # with the batch anyway — drop the answer, never let a
                    # cancellation kill the pipeline thread.
                    pass
        finally:
            with self._lock:
                self._n_unanswered -= len(futures)
                if self._n_unanswered <= 0:
                    self._idle.notify_all()

    def _expire(self, futures: list[ServeFuture]) -> None:
        self._core.bump("deadline_misses", len(futures))
        if self._core.controller is not None:
            for _ in futures:
                self._core.controller.note_deadline_miss()
        self._resolve(futures, [
            DeadlineExceeded("deadline expired while queued")
            for _ in futures])

    def _prep_entries(self, entries):
        """Host-prep a batch with PER-QUERY error containment.

        A preprocess failure (or poison screen) fails only that query's
        future with a typed :class:`PoisonQuery` — its batch-mates proceed.
        Pooled entries (:class:`_Staged`) COLLECT their histogram from the
        staging ring instead of vectorizing here; an ingest-process death
        surfaces as that query's :class:`~repro_torch.serving.errors
        .IngestCrashed` with the same containment.  Returns
        (qs, futures, deadlines, traces) for the healthy queries.
        """
        qs, futs, dls, trs, errs = [], [], [], [], []
        for payload, fut, dl, cid, tr in entries:
            try:
                if isinstance(payload, _Staged):
                    # Fault hooks (crash/preprocess) already ran in the
                    # child, keyed by this ticket — don't re-key them on
                    # the in-thread counter.
                    q = self._pool.collect(payload.ticket)
                    _check_query(*q)
                else:
                    idx = self._prep_idx
                    self._prep_idx = idx + 1
                    if self._core.faults is not None:
                        self._core.faults.on_prep(idx)
                    q = self._prep(payload, cid)
            except ServingError as e:
                if tr is not None:
                    tr.finish()
                    e.trace = tr
                errs.append((fut, e))
            except Exception as e:
                pe = PoisonQuery(f"preprocess failed: {e}")
                pe.__cause__ = e
                if tr is not None:
                    tr.finish()
                    pe.trace = tr
                errs.append((fut, pe))
            else:
                qs.append(q)
                futs.append(fut)
                dls.append(dl)
                trs.append(tr)
        if errs:
            bad_futs, bad_errs = zip(*errs)
            self._resolve(list(bad_futs), list(bad_errs))
        return qs, futs, dls, trs

    def _collect_one(self) -> None:
        with self._lock:
            entry = self._inflight.popleft()
        handle, futures, deadlines = entry
        self._crash_victims = futures
        try:
            answers = self._core.collect(handle)
        except Exception as e:  # typed forwarding; crashes escape higher
            if _is_device_fault(e):
                raise _DeviceFault(str(e)) from e
            err = _as_serving_error(e, "batch collect failed")
            self._crash_victims = []
            self._resolve(futures, [err] * len(futures))
            return
        # Strict delivery-time deadline check: an answer that arrives past
        # its deadline is a miss, delivered as DeadlineExceeded.
        now = time.monotonic()
        late = [dl is not None and now > dl for dl in deadlines]
        if self._ranks > 1:
            late = self._agree_delivery(late)
        out = []
        for a, dl, miss in zip(answers, deadlines, late):
            if miss:
                self._core.bump("deadline_misses")
                if self._core.controller is not None:
                    self._core.controller.note_deadline_miss()
                err = DeadlineExceeded(
                    "answer ready past rank 0's deadline" if dl is None
                    else f"answer ready {now - dl:.3f}s past the deadline")
                tr = getattr(a, "trace", None)
                if tr is not None:
                    err.trace = tr
                out.append(err)
            else:
                out.append(a)
        self._crash_victims = []
        self._resolve(futures, out)

    def _agree_delivery(self, late: list) -> list:
        """Rank 0's late flags for a collected batch, and its latency
        average (the rush margin's input and ``stats["ewma_latency_s"]``),
        on every rank."""
        ewma = self._core._ewma
        got = self._core.agree([*late, ewma is not None,
                                _f64_bits(ewma or 0.0)])
        if not self._lead and got[-2]:
            self._core._ewma = _bits_f64(got[-1])
            with self._core._stats_lock:
                self._core.stats["ewma_latency_s"] = self._core._ewma
        return [bool(x) for x in got[:-2]]

    def _dispatch_batch(self, qs, futures, deadlines, traces,
                        corpus_id: str, depth: int, t_pop: float,
                        padded) -> None:
        """Dispatch a prepared batch and put it in flight; a failure that is
        not a crash resolves its futures with a typed error."""
        self._crash_victims = futures
        try:
            handle = self._core.dispatch(
                qs, queue_depth=depth, corpus_id=corpus_id, traces=traces,
                t_dequeue=t_pop, t_prep0=t_pop, padded=padded)
        except Exception as e:  # typed forwarding; crashes escape
            if _is_device_fault(e):
                raise _DeviceFault(str(e)) from e
            err = _as_serving_error(e, "batch dispatch failed")
            self._crash_victims = []
            self._resolve(futures, [err] * len(futures))
        else:
            with self._lock:
                self._inflight.append((handle, futures, deadlines))
            self._crash_victims = []

    def _oldest_ready(self) -> bool:
        if not self._inflight:
            return False
        event = self._inflight[0][0].event
        # No event: CPU results, ready when dispatch returned.
        return event is None or bool(event.query())

    def _run(self) -> None:
        """The worker's loop on every rank: rank 0's decision, shared, then
        acted on.  On one rank (or none) ``agree`` is the identity and
        issues no collective."""
        if self._core.device.type == "cuda":
            # Kernels launch on the current stream of THIS thread's device.
            torch.cuda.set_device(self._core.device)
        while True:
            head, drops = self._decide() if self._lead else ([0] * 6, [])
            head = self._core.agree(head)
            if head[2]:
                drops = self._core.agree(drops if self._lead
                                         else [0] * head[2])
            if self._act(head, drops):
                return

    def _decide(self) -> tuple[list[int], list[int]]:
        """Rank 0: the next decision on its clock and queue: drop lapsed
        (or rejected) entries first; then a batch once it is due (fill,
        staleness, rush, flush, close), else collect the oldest batch in
        flight once its result is ready, else wait; plus the corpus changes
        waiting.  Nothing leaves the queue here: every rank does that in
        :meth:`_act`."""
        have_inflight = bool(self._inflight)
        t_idle = time.perf_counter()
        with self._lock:
            while True:
                n_chg = len(self._changes)
                mono = time.monotonic()
                drops = [2 * j + (fut in self._rejects)
                         for j, (_p, fut, dl, _c, _t) in enumerate(self._queue)
                         if fut in self._rejects
                         or (dl is not None and dl <= mono)]
                if drops:
                    return [_OP_IDLE, n_chg, len(drops), 0, 0,
                            drops[-1] // 2 + 1], drops
                if self._queue:
                    timeout = self._batch_due_locked(time.perf_counter())
                    if timeout is None:
                        n = self._head_run_locked()
                        return [_OP_BATCH, n_chg, 0, n,
                                len(self._queue) - n, n], []
                    if n_chg:
                        return [_OP_IDLE, n_chg, 0, 0, 0, 0], []
                    if have_inflight:
                        self._work.wait(min(timeout, 0.005))
                        if self._oldest_ready():
                            return [_OP_COLLECT, len(self._changes), 0, 0,
                                    0, 0], []
                    else:
                        self._work.wait(timeout)
                    continue
                self._flush_requested = False
                if have_inflight:
                    return [_OP_COLLECT, n_chg, 0, 0, 0, 0], []
                if n_chg:
                    return [_OP_IDLE, n_chg, 0, 0, 0, 0], []
                if self._closed:
                    return [_OP_EXIT, 0, 0, 0, 0, 0], []
                if time.perf_counter() - t_idle >= _MESH_IDLE_S:
                    return [_OP_IDLE, 0, 0, 0, 0, 0], []
                self._work.wait(0.1)

    def _act(self, head: list[int], drops: list[int]) -> bool:
        """Apply one shared decision on this rank; True to exit."""
        op, n_chg, _n_drop, take, depth, need = head
        with self._lock:
            # A follower's clock decides nothing: wait for what rank 0 saw
            # (past the queue's capacity, if rank 0 queued entries that its
            # admission check rejected).
            while len(self._changes) < n_chg or len(self._queue) < need:
                if self._lead:
                    # Rank 0 decided on what it held: only a close that
                    # failed everything unresolved took it away since.
                    return True
                self._starved = len(self._queue) < need
                self._not_full.notify_all()
                self._work.wait(0.1)
            self._starved = False
            changes = [self._changes.popleft() for _ in range(n_chg)]
        for fn, done in changes:
            try:
                done.set_result(fn())
            except Exception as e:  # the caller's, as on one rank
                done.set_exception(e)
        if drops:
            self._drop(drops)
        if op == _OP_BATCH:
            self._serve_agreed(take, depth)
        elif op == _OP_COLLECT:
            self._collect_one()
        elif op == _OP_EXIT:
            with self._lock:
                self._closed = True
            return True
        return False

    def _drop(self, drops: list[int]) -> None:
        """Fail the queue entries at rank 0's positions: lapsed ones with
        DeadlineExceeded (as the sweep does), rejected ones with
        QueryRejected (as the mesh-less ``submit`` raises)."""
        kinds = {d // 2: d % 2 for d in drops}
        expired, rejected = [], []
        with self._lock:
            entries = list(self._queue)
            self._queue = deque(e for j, e in enumerate(entries)
                                if j not in kinds)
            for j in sorted(kinds):
                payload, fut, _dl, _c, tr = entries[j]
                self._rejects.pop(fut, None)
                if isinstance(payload, _Staged):
                    self._pool.skip(payload.ticket)
                if tr is not None:
                    tr.finish()
                    fut.trace = tr
                (rejected if kinds[j] else expired).append(fut)
            if not self._queue:
                self._batch_t0 = None
            self._not_full.notify_all()
        if expired:
            self._expire(expired)
        if rejected:
            self._resolve(rejected, [QueryRejected(
                "rank 0's admission check rejected the query (its deadline "
                "ran out at submit)") for _ in rejected])

    def _serve_agreed(self, take: int, depth: int) -> None:
        """Take the ``take`` entries at the queue head, prepare them, and
        serve them if every rank's batch digest is rank 0's."""
        with self._lock:
            batch = self._pop_batch_locked(take, time.perf_counter())
            for entry in batch:
                self._rejects.pop(entry[1], None)
        # The batch leaves the queue HERE: queue_wait ends and host prep
        # (batch_formation) starts now, not after _prep_entries, so the
        # vectorize time the ingest pool removes is not hidden in
        # queue_wait.
        t_pop = time.perf_counter()
        qs, futures, deadlines, traces = self._prep_entries(batch)
        padded = pad_batch(qs, len(qs), self._core.cfg.h_max) if qs else None
        if self._ranks == 1:
            # The depth after prep, as the mesh-less reference reads it.
            with self._lock:
                depth = len(self._queue)
        else:
            digests = self._core.gather([_batch_digest(padded)])
            if len({d for (d,) in digests}) > 1:
                self._resolve(futures, [MeshDivergence(
                    "the ranks prepared different batches from the entries "
                    "rank 0 named; no rank served it") for _ in futures])
                qs = []
        if qs:
            self._dispatch_batch(qs, futures, deadlines, traces,
                                 batch[0][3], depth, t_pop, padded)
        if len(self._inflight) >= self._depth:
            self._collect_one()

    # -- supervisor --------------------------------------------------------
    def _supervised_run(self) -> None:
        """Worker entry point: run the serve loop under a supervisor.

        Any escape from :meth:`_run` — including ``BaseException``-derived
        injected crashes that the per-batch typed forwarding deliberately
        does not catch — fails the in-flight futures with
        :class:`WorkerCrashed` (crash chained as ``__cause__``), steps the
        degradation controller, and RESTARTS the loop: queued entries were
        never touched, so submission order is preserved.  After
        ``cfg.max_worker_restarts`` crashes the server closes itself and
        fails everything unresolved with :class:`ServerClosed` — the
        no-future-left-behind contract holds even in permanent failure.
        A :class:`_DeviceFault` (a CUDA error that left the context
        unusable) gives up at once: a restart would only fail again.
        """
        while True:
            try:
                self._run()
                return  # clean exit (closed + drained)
            except BaseException as e:  # noqa: BLE001 — supervisor boundary
                with self._lock:
                    dead, self._inflight = self._inflight, deque()
                # The batch mid-dispatch/mid-collect when the crash escaped
                # never made it into (or already left) `_inflight` — its
                # futures are staged in `_crash_victims`.
                victims = list(self._crash_victims)
                self._crash_victims = []
                for _h, futs, _d in dead:
                    victims.extend(futs)
                n_restarts = self._core.bump("worker_restarts")
                self._core.obs.events.append(WorkerRestart(count=n_restarts))
                if self._core.controller is not None:
                    self._core.controller.note_crash()
                wc = WorkerCrashed(
                    f"serve worker died mid-batch: {type(e).__name__}: {e}")
                wc.__cause__ = e
                if victims:
                    self._resolve(victims, [wc] * len(victims))
                if isinstance(e, _DeviceFault):
                    with self._lock:
                        self._closed = True
                    self._fail_unresolved(ServerClosed(
                        f"the device context failed ({e}); the server "
                        "closed without serving on another device"))
                    return
                restarts = n_restarts
                if restarts > self._core.cfg.max_worker_restarts:
                    with self._lock:
                        self._closed = True
                    self._fail_unresolved(ServerClosed(
                        f"serve worker crashed {restarts} times "
                        f"(> max_worker_restarts="
                        f"{self._core.cfg.max_worker_restarts}); giving up"))
                    return
                # Restart the loop: still-queued requests dispatch next, in
                # their original submission order.

    def _fail_unresolved(self, exc: ServingError) -> None:
        """Fail every accepted-but-unresolved future with `exc`."""
        with self._lock:
            queued = list(self._queue)
            self._queue.clear()
            dead, self._inflight = self._inflight, deque()
            self._batch_t0 = None
            self._not_full.notify_all()
        # A batch wedged inside dispatch()/collect() on a stuck worker is in
        # neither the queue nor `_inflight` — take it from the staging list
        # (not cleared: the worker owns it; double-resolution is absorbed by
        # the InvalidStateError guard in `_resolve`).
        futs: list[ServeFuture] = list(self._crash_victims)
        for _h, bfuts, _d in dead:          # then in-flight (older first)...
            futs.extend(bfuts)
        futs.extend(f for _p, f, _d, _c, _t in queued)  # ...then the queue
        if self._pool is not None:
            for _p, _f, _d, _c, _t in queued:
                if isinstance(_p, _Staged):
                    self._pool.skip(_p.ticket)
        if futs:
            self._resolve(futs, [exc] * len(futs))
        with self._lock:
            changes, self._changes = self._changes, deque()
        for _fn, done in changes:
            done.set_exception(exc)
