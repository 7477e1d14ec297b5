"""Multi-tenant corpus cache for the serving core (the counterpart of
``repro.serving.corpus_manager``).

One server process fronts MANY corpora (tenants).  Each corpus is a
:class:`~repro_torch.core.lc_rwmd.SegmentedEngine` — base + delta segments
with tombstone deletes — wrapped in a :class:`CorpusState` that also owns
that corpus's serve step and (when adaptive rerank is on) its private
:class:`~repro_torch.core.pipeline.AdaptiveRefineBudget`.  Budgets are
PER-CORPUS on purpose: one tenant's pruning failures must never inflate —
or, via the decay floor, permanently pin — another tenant's rerank budget.

:class:`CorpusManager` keys the states by ``corpus_id`` in an LRU order
and accounts device residency in BYTES (``engine.nbytes`` — the segments'
ELL matrices, restricted embeddings and vocab maps — plus ``index.nbytes``
for an indexed corpus).  When ``cache_bytes`` is exceeded,
least-recently-served corpora are EVICTED: their device tensors and serve
step are dropped and a host-side snapshot (ids, weights, live mask,
budget), copied off the card with ``.cpu().numpy()``, is kept.
``checkout`` of an evicted corpus READMITS it — the engine is rebuilt from
the snapshot as one base segment (global doc ids and tombstones are
restored exactly) and its budget's decay floor is reset
(:meth:`~repro_torch.core.pipeline.AdaptiveRefineBudget.reset_decay_floor`):
the floor was measured against device state that no longer exists, and
the rebuilt serve step must be allowed to re-probe it.  An indexed
corpus's index is rebuilt with the same seed.

Lifecycle between batches
-------------------------
``ingest`` / ``delete_docs`` / ``compact`` mutate a corpus in place.  The
serve step does NOT need rebuilding: the segmented serve closure re-reads
``engine.version`` per call.  Segments are not padded (the kernels take
any shape, and eager PyTorch has no trace to reuse), so ``engine_kw``
carries no ``delta_pad`` / ``vocab_pad``.  ``ingest`` optionally gates
near-duplicates with
:func:`repro_torch.workloads.neighbors.ingest_dedup_mask` (symmetric
LC-RWMD lower-bounds WMD, so no true duplicate is ever admitted).  All
lifecycle entry points and the per-batch ``checkout`` share one
re-entrant ``lock``, making corpus mutation admissible BETWEEN batches
while a server's worker thread is live.

One stream: every call here issues its CUDA work on the current (default)
stream of the calling thread, as the serve loop does on its thread, so
host order under ``lock`` is device order and the caching allocator never
hands a tensor an in-flight batch still reads to another stream.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np

import torch

from repro_torch.core.lc_rwmd import SegmentedEngine, as_f32
from repro_torch.core.pipeline import AdaptiveRefineBudget
from repro_torch.data.docs import DocSet
from repro_torch.device import resolve_device

#: The corpus id used when a server is built with a single resident set and
#: callers never pass ``corpus_id=``.
DEFAULT_CORPUS = "default"


class CorpusState:
    """One corpus's serving state: engine + serve step + budget.

    ``serve`` is filled lazily by the serving core (``None`` right after
    :meth:`CorpusManager.add_corpus` or a readmission) and swapped on
    adaptive-budget rebuilds; dropping the state drops the device
    residency (the engine holds the segment tensors, and under a mesh the
    serve closure holds this rank's slices of them: its rows, ELL ids
    made relative to its vocabulary span, and its rows of each restricted
    table, which are freed with it).
    """

    __slots__ = ("corpus_id", "engine", "budget", "serve")

    #: Routed-serving index; always None on the plain state (the serving
    #: core reads ``st.index`` uniformly).
    index = None

    def __init__(self, corpus_id: str, engine: SegmentedEngine,
                 budget: AdaptiveRefineBudget | None = None):
        self.corpus_id = corpus_id
        self.engine = engine
        self.budget = budget
        self.serve = None

    @property
    def nbytes(self) -> int:
        """Device bytes this corpus pins (the eviction accounting unit)."""
        return self.engine.nbytes


class IndexedCorpusState(CorpusState):
    """A corpus state that carries a :class:`repro_torch.index.ClusterIndex`.

    The index's per-cell tensors and centroids are device-resident beside
    the engine's, so they COUNT toward the manager's byte accounting (an
    indexed corpus is roughly twice the eviction weight).  Lifecycle
    coupling lives in the manager: ingest appends to the nearest cell
    (:meth:`ClusterIndex.add`), deletes need nothing (live masks re-derive
    from the engine), and compaction re-partitions deterministically
    (:meth:`ClusterIndex.rebuild` — same seed, same cells).
    """

    __slots__ = ("index",)

    def __init__(self, corpus_id: str, engine: SegmentedEngine,
                 budget: AdaptiveRefineBudget | None = None, index=None):
        super().__init__(corpus_id, engine, budget)
        self.index = index

    @property
    def nbytes(self) -> int:
        n = self.engine.nbytes
        if self.index is not None:
            n += self.index.nbytes
        return n


class _Evicted(NamedTuple):
    """Host-side spill of an evicted corpus: everything needed to readmit
    it bit-exactly (global ids, tombstones, and the adaptive budget's
    learned operating point — minus its now-stale decay floor)."""

    ids: np.ndarray        # (n, h) int32 word ids (tombstoned rows kept)
    weights: np.ndarray    # (n, h) f32 weights
    live: np.ndarray       # (n,) bool live mask
    budget: AdaptiveRefineBudget | None


class CorpusManager:
    """LRU engine cache keyed by corpus id with device-byte accounting.

    Engines live on ``device`` (``None`` → ``"cuda"``, which raises without
    a card).  ``engine_kw`` is forwarded to every :class:`SegmentedEngine`
    build (``row_block``, ``vocab_chunk``, ``bf16_matmul``);
    ``make_budget`` (optional) builds a fresh per-corpus
    :class:`AdaptiveRefineBudget` from an engine.  ``cache_bytes=None``
    disables eviction (every corpus stays resident).
    """

    def __init__(self, emb, *, device=None, cache_bytes: int | None = None,
                 engine_kw: dict | None = None,
                 make_budget: Callable[[SegmentedEngine],
                                       AdaptiveRefineBudget | None]
                 | None = None,
                 make_index: Callable[[SegmentedEngine], object] | None = None,
                 dedup_threshold: float | None = None,
                 obs=None):
        self.device = resolve_device(device)
        self.emb = as_f32(emb, self.device)
        self.cache_bytes = cache_bytes
        self.dedup_threshold = dedup_threshold
        self._engine_kw = dict(engine_kw or {})
        self._make_budget = make_budget
        self._make_index = make_index
        self._states: OrderedDict[str, CorpusState] = OrderedDict()
        self._evicted: dict[str, _Evicted] = {}
        # Per-corpus query vectorizers (preprocess hooks).  Routed to the
        # ingest pool when one is configured — pool workers are separate
        # PROCESSES, so these must be picklable (dataclass vectorizers
        # like repro_torch.data.vectorizer.* qualify; closures do not).
        self.vectorizers: dict[str, Callable] = {}
        # Shared with the serving core: held across checkout+dispatch and
        # every lifecycle mutation, so ingest/delete/compact from another
        # thread land BETWEEN batches, never mid-dispatch.
        self.lock = threading.RLock()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "readmissions": 0, "deduped_docs": 0}
        self.obs = obs
        if obs is not None:
            m = obs.metrics
            self._m_hits = m.counter(
                "corpus_cache_hits_total", "Resident-corpus checkouts.")
            self._m_misses = m.counter(
                "corpus_cache_misses_total",
                "Checkouts that had to readmit an evicted corpus.")
            self._m_evict = m.counter(
                "corpus_evictions_total", "LRU corpus evictions to host.")
            self._m_readmit = m.counter(
                "corpus_readmissions_total",
                "Evicted corpora rebuilt on checkout.")
            self._m_resident = m.gauge(
                "corpus_resident_bytes",
                "Device bytes pinned by resident corpora.")
        else:
            self._m_hits = self._m_misses = None
            self._m_evict = self._m_readmit = self._m_resident = None

    def _set_resident_gauge_locked(self) -> None:
        if self._m_resident is not None:
            self._m_resident.set(
                sum(st.nbytes for st in self._states.values()))

    # -- views -------------------------------------------------------------
    @property
    def resident_bytes(self) -> int:
        """Device bytes across all currently-resident corpora."""
        with self.lock:
            return sum(st.nbytes for st in self._states.values())

    @property
    def corpus_ids(self) -> list[str]:
        """Every known corpus id, resident or evicted (stable order)."""
        with self.lock:
            return list(self._states) + sorted(self._evicted)

    def is_resident(self, corpus_id: str) -> bool:
        with self.lock:
            return corpus_id in self._states

    def has_corpus(self, corpus_id: str) -> bool:
        """Lock-free membership check for the submit hot path.

        Deliberately does NOT take ``lock``: a producer validating a
        ``corpus_id`` must never serialize behind an in-progress dispatch
        (dict membership reads are atomic under the GIL, and corpora are
        only ever added — a checkout or an eviction moves an id between the
        resident and evicted maps, adding it to one before taking it out of
        the other, so it exists in at least one throughout).
        """
        return corpus_id in self._states or corpus_id in self._evicted

    def snapshot(self) -> dict:
        """Best-effort cache snapshot for ``health()`` / operators.

        Lock-free on purpose: liveness probes must answer even while a
        worker is wedged mid-dispatch holding ``lock``.
        """
        states = list(self._states.values())
        return {
            **self.stats,
            "resident": [st.corpus_id for st in states],
            "evicted": sorted(self._evicted),
            "resident_bytes": sum(st.nbytes for st in states),
            "cache_bytes": self.cache_bytes,
        }

    def vectorizer_for(self, corpus_id: str) -> Callable | None:
        """This corpus's query vectorizer, or None (server default applies).

        Lock-free like :meth:`has_corpus` — the ingest path must never
        serialize behind an in-progress dispatch.
        """
        return self.vectorizers.get(corpus_id)

    # -- admission ---------------------------------------------------------
    def add_corpus(self, corpus_id: str, docs: DocSet,
                   vectorizer: Callable | None = None) -> CorpusState:
        """Build and admit a new corpus; errors on a duplicate id.

        ``vectorizer`` (optional) becomes this corpus's query preprocess
        hook; servers route it to their ingest pool so raw payloads for
        this tenant vectorize against the right vocabulary.
        """
        with self.lock:
            if corpus_id in self._states or corpus_id in self._evicted:
                raise ValueError(f"corpus {corpus_id!r} already exists")
            if vectorizer is not None:
                self.vectorizers[corpus_id] = vectorizer
            engine = self._engine(docs)
            budget = self._make_budget(engine) if self._make_budget else None
            st = self._new_state(corpus_id, engine, budget)
            self._states[corpus_id] = st
            self._enforce_budget(keep=corpus_id)
            self._set_resident_gauge_locked()
            return st

    def checkout(self, corpus_id: str = DEFAULT_CORPUS) -> CorpusState:
        """Fetch a corpus for serving: LRU-touch it, readmitting if evicted.

        Raises ``KeyError`` for an unknown id (typed rejection upstream).
        """
        with self.lock:
            st = self._states.get(corpus_id)
            if st is not None:
                self.stats["hits"] += 1
                if self._m_hits is not None:
                    self._m_hits.inc()
                self._states.move_to_end(corpus_id)
                return st
            # The id leaves the evicted map only once it is resident again:
            # the lock-free ``has_corpus`` must see it in one map throughout.
            snap = self._evicted.get(corpus_id)
            if snap is None:
                raise KeyError(f"unknown corpus {corpus_id!r}")
            self.stats["misses"] += 1
            self.stats["readmissions"] += 1
            if self._m_misses is not None:
                self._m_misses.inc()
                self._m_readmit.inc()
            st = self._readmit(corpus_id, snap)
            self._states[corpus_id] = st
            del self._evicted[corpus_id]
            if self.obs is not None:
                from repro_torch.obs import CorpusReadmitted
                self.obs.events.append(CorpusReadmitted(corpus_id=corpus_id))
            self._enforce_budget(keep=corpus_id)
            self._set_resident_gauge_locked()
            return st

    def _engine(self, docs: DocSet) -> SegmentedEngine:
        return SegmentedEngine(docs, self.emb, device=self.device,
                               **self._engine_kw)

    def _new_state(self, corpus_id: str, engine: SegmentedEngine,
                   budget) -> CorpusState:
        """Plain or indexed state, depending on the ``make_index`` hook."""
        index = self._make_index(engine) if self._make_index else None
        if index is None:
            return CorpusState(corpus_id, engine, budget)
        return IndexedCorpusState(corpus_id, engine, budget, index)

    def _readmit(self, corpus_id: str, snap: _Evicted) -> CorpusState:
        docs = DocSet(ids=torch.from_numpy(snap.ids),
                      weights=torch.from_numpy(snap.weights))
        engine = self._engine(docs)
        dead = np.nonzero(~snap.live)[0]
        if dead.size:
            engine.delete(dead)   # restore tombstones (global ids stable)
        if snap.budget is not None:
            # The decay floor was measured pre-eviction; the rebuilt step
            # must be allowed to re-probe it (satellite: stale-floor reset).
            snap.budget.reset_decay_floor()
        # The index is NOT spilled: readmission re-partitions with the
        # same seed over the same docs, so the cells come back identical.
        return self._new_state(corpus_id, engine, snap.budget)

    # -- eviction ----------------------------------------------------------
    def _enforce_budget(self, keep: str) -> None:
        """Evict LRU corpora until under ``cache_bytes`` (never ``keep``)."""
        if self.cache_bytes is None:
            return
        while (sum(st.nbytes for st in self._states.values())
               > self.cache_bytes):
            victim = next((cid for cid in self._states if cid != keep), None)
            if victim is None:
                return  # the kept corpus alone exceeds the budget
            self.evict(victim)

    def evict(self, corpus_id: str) -> None:
        """Spill one corpus to host memory and drop its device residency."""
        with self.lock:
            st = self._states[corpus_id]
            eng = st.engine
            res = eng.resident
            nbytes = st.nbytes
            # Spilled before it leaves the resident map (see ``checkout``).
            self._evicted[corpus_id] = _Evicted(
                ids=res.ids.cpu().numpy(), weights=res.weights.cpu().numpy(),
                live=eng.live_mask(), budget=st.budget)
            del self._states[corpus_id]
            self.stats["evictions"] += 1
            if self._m_evict is not None:
                self._m_evict.inc()
            if self.obs is not None:
                from repro_torch.obs import CorpusEvicted
                self.obs.events.append(
                    CorpusEvicted(corpus_id=corpus_id, nbytes=nbytes))
            self._set_resident_gauge_locked()
            # st drops out of scope: the engine's segment tensors, the
            # index's cells and the serve closure are freed with it.

    # -- lifecycle (admissible between batches) ----------------------------
    def ingest(self, corpus_id: str, docs: DocSet, *,
               dedup_threshold: float | None = None,
               ) -> tuple[np.ndarray, np.ndarray]:
        """Append docs to a corpus as one delta segment.

        With a ``dedup_threshold`` (falling back to the manager default),
        near-duplicates of live docs — and of earlier docs in the same
        batch — are gated out first via
        :func:`repro_torch.workloads.neighbors.ingest_dedup_mask`.

        Returns ``(global_ids, admitted)``: the assigned global doc ids of
        the admitted docs and the (B,) admission mask.
        """
        thr = dedup_threshold if dedup_threshold is not None \
            else self.dedup_threshold
        with self.lock:
            st = self.checkout(corpus_id)
            keep = np.ones(docs.n_docs, dtype=bool)
            if thr is not None and docs.n_docs:
                from repro_torch.workloads.neighbors import ingest_dedup_mask
                keep = ingest_dedup_mask(st.engine, docs, float(thr))
                self.stats["deduped_docs"] += int((~keep).sum())
                if not keep.all():
                    sel = torch.from_numpy(np.nonzero(keep)[0]).to(
                        docs.device)
                    docs = DocSet(ids=docs.ids[sel], weights=docs.weights[sel])
            gids = st.engine.append(docs)
            if st.index is not None and len(gids):
                # Nearest-cell assignment; O(touched cells), not O(corpus).
                st.index.add(gids, docs)
            if st.budget is not None:
                st.budget.on_corpus_change(max(1, st.engine.n_live))
            self._enforce_budget(keep=corpus_id)
            self._set_resident_gauge_locked()
            return gids, keep

    def delete_docs(self, corpus_id: str, doc_ids) -> int:
        """Tombstone global doc ids; returns how many were newly deleted."""
        with self.lock:
            st = self.checkout(corpus_id)
            removed = st.engine.delete(doc_ids)
            if removed and st.budget is not None:
                st.budget.on_corpus_change(max(1, st.engine.n_live))
            return removed

    def compact(self, corpus_id: str) -> None:
        """Merge a corpus's delta segments into one base segment."""
        with self.lock:
            st = self.checkout(corpus_id)
            st.engine.compact()
            if st.index is not None:
                # Deterministic re-partition (same seed): tombstones are
                # gone from the merged base, so cells shrink back to the
                # live set and radii tighten.
                st.index.rebuild()


__all__ = ["DEFAULT_CORPUS", "CorpusManager", "CorpusState",
           "IndexedCorpusState"]
