"""Per-request span timelines through the serving pipeline (the port's copy
of ``repro.obs.tracing``).

A query admitted to either server carries a :class:`QueryTrace`; every
query that rides the same flush shares one :class:`BatchTrace`.  The
stage vocabulary is fixed (``STAGES``) so downstream tooling can rely on
names:

    admission → queue_wait → batch_formation → dispatch
              → device_compute → validation → delivery

Per-query stages (admission, queue_wait, delivery) live on the
QueryTrace; batch-level stages (batch_formation, dispatch,
device_compute, validation) live on the BatchTrace and are shared by
reference across batch-mates — recording them costs O(1) per batch, not
per query.

**Async-dispatch awareness** is the point of the split between
``dispatch`` and ``device_compute``: on the card the serve step returns
once its kernels and the result copies are queued on the stream, so the
dispatch span measures *host* launch cost only.  ``device_compute`` opens
when dispatch returns and closes when collect's wait on the batch's CUDA
event returns — the host-observable end of the batch's device work.  With
two batches in flight it therefore includes queueing behind the previous
batch; that is the latency the *request* experienced, which is what a
trace is for.  On the CPU the work is done when dispatch returns.

Traces attach to results: ``Answer.trace`` / ``ServeFuture.trace`` hold
the completed :class:`QueryTrace` (None when tracing is disabled).
``timeline()`` merges query- and batch-level spans sorted by start time;
``to_dict()`` is JSON-able for export.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

#: Canonical stage names, in pipeline order.
STAGES: tuple[str, ...] = (
    "admission", "queue_wait", "batch_formation", "dispatch",
    "device_compute", "validation", "delivery",
)

_BATCH_STAGES = frozenset(
    {"batch_formation", "dispatch", "device_compute", "validation"})


class _SpanHolder:
    """Mutable span store: name -> (t_start, t_end)."""

    __slots__ = ("spans", "_open")

    def __init__(self):
        self.spans: dict[str, tuple[float, float]] = {}
        self._open: dict[str, float] = {}

    def begin(self, stage: str) -> None:
        self._open[stage] = time.perf_counter()

    def end(self, stage: str) -> None:
        t0 = self._open.pop(stage, None)
        if t0 is not None:
            self.spans[stage] = (t0, time.perf_counter())

    def span(self, stage: str, t0: float, t1: float) -> None:
        self.spans[stage] = (t0, t1)

    @contextlib.contextmanager
    def timed(self, stage: str) -> Iterator[None]:
        self.begin(stage)
        try:
            yield
        finally:
            self.end(stage)


class BatchTrace(_SpanHolder):
    """Spans shared by every query in one dispatched flush."""

    __slots__ = ("seq", "tier")

    def __init__(self, seq: int):
        super().__init__()
        self.seq = seq
        self.tier = 0


class QueryTrace(_SpanHolder):
    """One query's journey; ``batch`` links the shared flush spans."""

    __slots__ = ("t_admit", "batch", "done")

    def __init__(self):
        super().__init__()
        self.t_admit = time.perf_counter()
        self.batch: BatchTrace | None = None
        self.done = False
        self.span("admission", self.t_admit, self.t_admit)

    def joined_batch(self, batch: BatchTrace | None, t_dequeue: float | None = None
                     ) -> None:
        """Close queue_wait (admission → dequeue) and bind the batch."""
        self.batch = batch
        self.span("queue_wait",
                  self.t_admit,
                  time.perf_counter() if t_dequeue is None else t_dequeue)

    def finish(self) -> None:
        now = time.perf_counter()
        self.span("delivery", now, now)
        self.done = True

    @property
    def tier(self) -> int:
        return self.batch.tier if self.batch is not None else 0

    def timeline(self) -> list[tuple[str, float, float]]:
        """All spans (query-level + shared batch-level), sorted by start."""
        merged = dict(self.spans)
        if self.batch is not None:
            for k, v in self.batch.spans.items():
                merged[k] = v
        return sorted(((name, t0, t1) for name, (t0, t1) in merged.items()),
                      key=lambda s: (s[1], STAGES.index(s[0])
                                     if s[0] in STAGES else len(STAGES)))

    def to_dict(self) -> dict:
        return {
            "tier": self.tier,
            "batch_seq": self.batch.seq if self.batch is not None else None,
            "done": self.done,
            "spans": [
                {"stage": name, "start": t0, "end": t1,
                 "duration_s": t1 - t0,
                 "scope": "batch" if name in _BATCH_STAGES else "query"}
                for name, t0, t1 in self.timeline()
            ],
        }


class Tracer:
    """Factory for traces; a disabled tracer mints ``None`` everywhere,
    so instrumentation sites guard with ``if trace is not None`` and the
    disabled cost is one attribute check + one comparison per site."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._n_queries = 0
        self._n_batches = 0

    def admit(self) -> QueryTrace | None:
        if not self.enabled:
            return None
        with self._lock:
            self._n_queries += 1
        return QueryTrace()

    def batch(self, seq: int) -> BatchTrace | None:
        if not self.enabled:
            return None
        with self._lock:
            self._n_batches += 1
        return BatchTrace(seq)

    def snapshot(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "queries_traced": self._n_queries,
                    "batches_traced": self._n_batches}


@contextlib.contextmanager
def profiler_session(logdir: str) -> Iterator[None]:
    """Opt-in ``torch.profiler`` session that writes a Chrome trace
    (``trace.json``) into ``logdir``; CUDA activity is recorded when a card
    is present.  Without a usable profiler this is a no-op context."""
    import os

    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    except Exception:  # profiler unavailable in this build
        yield
        return
    with prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


__all__ = ["BatchTrace", "QueryTrace", "STAGES", "Tracer",
           "profiler_session"]
