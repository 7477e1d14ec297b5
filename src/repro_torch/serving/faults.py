"""Deterministic fault injection for the serving plane (the port's copy of
``repro.serving.faults``).

A :class:`FaultPlan` declares, ahead of time, exactly which batches and
queries fail and how; a :class:`FaultInjector` (installed via the servers'
``faults=`` constructor argument) applies the plan at the serving core's
well-defined hook points:

  * ``on_prep(query_index)``   — host stage, per query: raise a preprocess
    exception for chosen submission indices (FIFO single-worker batching
    makes the prep order equal the submission order, so the index is
    deterministic).
  * ``on_dispatch(batch_seq)`` — host stage, per batch: inject artificial
    latency and/or crash the worker thread (the crash escapes the per-batch
    error forwarding on purpose — it exercises the worker SUPERVISOR, not
    the typed-error path).
  * ``poison_result(batch_seq, result, qs)`` — device stage: overwrite
    top-k distances with NaN.  Two flavors:
      - ``nan_batches`` keys on the batch sequence number → a TRANSIENT
        device fault; the validation layer's bisection retry (which passes
        ``batch_seq=None``) comes back clean and every query recovers.
      - ``poison_word_id`` marks queries (by their first word id) as
        STICKY poison — every serve call containing them is corrupted, so
        bisection must isolate and quarantine exactly those queries.

Each batch-keyed fault fires AT MOST ONCE (a crashed batch's sequence
number would otherwise recur after the supervisor restart and crash-loop
the worker).  The plan is pure data.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import numpy as np


class InjectedWorkerCrash(BaseException):
    """Simulated worker-thread death.

    Deliberately a ``BaseException``: the pipeline's per-batch error
    forwarding catches ``Exception`` only, so this escapes to the worker
    supervisor exactly like a genuine crash would.
    """


#: Sentinel for "poison every row of the batch" in ``nan_batches``.
ALL = "all"


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative, deterministic fault schedule.

    Attributes:
      preprocess_errors: submission indices whose host-stage prep raises
        (delivered to that query's future as a typed :class:`PoisonQuery`
        with the injected error as ``__cause__``; batch-mates unaffected).
      latency_s: batch sequence number → seconds of artificial host latency
        injected before that batch's dispatch (deadline-pressure tests).
      crash_batches: batch sequence numbers at which the worker thread dies
        (raises :class:`InjectedWorkerCrash`) before dispatching.
      nan_batches: batch sequence number → query slots whose top-k distances
        become NaN (or :data:`ALL` for the whole batch).  Transient: not
        re-applied on validation retries.
      poison_word_id: queries whose FIRST word id equals this are sticky
        poison — their rows (or, with ``poison_whole_batch``, their entire
        batch) come back NaN on every serve call, including retries.
      poison_whole_batch: whether a sticky poison query corrupts all rows of
        any batch containing it (models fused device kernels where one bad
        query wrecks the batch) or only its own row.
      ingest_crash: pool tickets at which the ingest worker PROCESS
        handling that ticket dies (``os._exit`` — no cleanup, like a
        segfaulting vectorizer extension).  Applied inside the child by
        :mod:`repro_torch.serving.ingest_pool`; with the in-thread prep path
        this field is inert.  Pool tickets are assigned in submission
        order, so the index is as deterministic as ``preprocess_errors``.
    """

    preprocess_errors: tuple[int, ...] = ()
    ingest_crash: tuple[int, ...] = ()
    latency_s: Mapping[int, float] = dataclasses.field(default_factory=dict)
    crash_batches: tuple[int, ...] = ()
    nan_batches: Mapping[int, object] = dataclasses.field(default_factory=dict)
    poison_word_id: int | None = None
    poison_whole_batch: bool = True


class FaultInjector:
    """Applies a :class:`FaultPlan` at the serving core's hook points.

    Stateful only to guarantee each batch-keyed fault fires once; the
    mapping from hook invocation to injected fault is otherwise a pure
    function of the plan.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fired_crashes: set[int] = set()
        self._fired_latency: set[int] = set()
        self._fired_nan: set[int] = set()

    # -- host stage --------------------------------------------------------
    def on_prep(self, query_index: int) -> None:
        if query_index in self.plan.preprocess_errors:
            raise RuntimeError(
                f"injected preprocess failure for query #{query_index}")

    def on_dispatch(self, batch_seq: int) -> None:
        lat = self.plan.latency_s.get(batch_seq)
        if lat and batch_seq not in self._fired_latency:
            self._fired_latency.add(batch_seq)
            time.sleep(lat)
        if (batch_seq in self.plan.crash_batches
                and batch_seq not in self._fired_crashes):
            self._fired_crashes.add(batch_seq)
            raise InjectedWorkerCrash(
                f"injected worker crash at batch #{batch_seq}")

    # -- device stage ------------------------------------------------------
    def _poison_slots(self, qs: Sequence[tuple]) -> list[int]:
        wid = self.plan.poison_word_id
        if wid is None:
            return []
        slots = []
        for j, (ids, _w) in enumerate(qs):
            arr = np.asarray(ids).reshape(-1)
            if arr.size and int(arr[0]) == wid:
                slots.append(j)
        return slots

    def poison_result(self, batch_seq: int | None, result, qs: Sequence[tuple]):
        """NaN-corrupt chosen rows of a ServeResult's top-k distances.

        ``batch_seq=None`` marks a validation retry: batch-keyed (transient)
        NaNs are skipped, sticky query-keyed poison still applies.
        """
        rows: set[int] = set()
        whole = False
        if batch_seq is not None and batch_seq not in self._fired_nan:
            spec = self.plan.nan_batches.get(batch_seq)
            if spec is not None:
                self._fired_nan.add(batch_seq)
                if spec == ALL:
                    whole = True
                else:
                    rows.update(int(s) for s in spec)  # type: ignore[union-attr]
        sticky = self._poison_slots(qs)
        if sticky:
            if self.plan.poison_whole_batch:
                whole = True
            else:
                rows.update(sticky)
        if not whole and not rows:
            return result
        # Corrupt on the result's device, before collect's copies to the
        # host: a fill on a view per row (whole batch: one fill), so no
        # host-to-device index copy enters the dispatch.
        d = result.topk.dists.clone()
        if whole:
            d.fill_(float("nan"))
        else:
            for r in sorted(rows):
                if r < d.shape[0]:
                    d[r].fill_(float("nan"))
        return result._replace(topk=result.topk._replace(dists=d))
