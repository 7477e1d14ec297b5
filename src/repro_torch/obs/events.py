"""Structured event log: typed serving-plane events in a bounded ring (the
port's copy of ``repro.obs.events``).

Everything that used to be a bare counter bump or a log line — tier
transitions, quarantine outcomes, worker restarts, corpus-cache churn,
budget rebuilds — becomes a frozen dataclass with a wall-clock timestamp,
appended to a lock-protected ``deque(maxlen=...)``.  The ring bound means
the log can stay on for the life of a server without growing; 1024
events cover hours of steady-state serving (these events are rare by
construction — they mark state *changes*, not per-request traffic).

``EventLog.snapshot()`` returns plain dicts (``kind`` + fields + ``t``),
so the log exports through ``metrics_snapshot()`` untouched.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Iterator


@dataclasses.dataclass(frozen=True)
class Event:
    """Base event: ``t`` is ``time.time()`` at emission."""

    t: float = dataclasses.field(default_factory=time.time, init=False)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = type(self).__name__
        return d


@dataclasses.dataclass(frozen=True)
class TierTransition(Event):
    """DegradationController moved the serving tier (0 ↔ 1 ↔ 2)."""

    tier: int
    reason: str


@dataclasses.dataclass(frozen=True)
class WorkerRestart(Event):
    """The async worker thread died and the supervisor restarted it."""

    count: int


@dataclasses.dataclass(frozen=True)
class QueryQuarantined(Event):
    """Bisection isolated a poisoned query inside a failed batch."""

    batch_seq: int
    slot: int


@dataclasses.dataclass(frozen=True)
class IngestCrash(Event):
    """An ingest-pool worker process died; a replacement was spawned
    (or the pool gave up, when ``restarts`` exceeded the cap)."""

    worker: int      # pool worker index
    ticket: int      # claimed ticket at death (-1 = none attributable)
    exit_code: int
    restarts: int    # cumulative pool restarts including this death


@dataclasses.dataclass(frozen=True)
class CorpusEvicted(Event):
    """CorpusManager pushed an engine's resident tensors back to host."""

    corpus_id: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class CorpusReadmitted(Event):
    """An evicted corpus was rebuilt on device after a checkout."""

    corpus_id: str


@dataclasses.dataclass(frozen=True)
class BudgetRebuild(Event):
    """Adaptive refine budget forced a serve-step rebuild."""

    corpus_id: str
    old_budget: int
    new_budget: int


class EventLog:
    """Thread-safe bounded event ring."""

    def __init__(self, maxlen: int = 1024):
        self._lock = threading.Lock()
        self._ring: deque[Event] = deque(maxlen=maxlen)

    def append(self, event: Event) -> None:
        with self._lock:
            self._ring.append(event)

    def snapshot(self) -> list[dict]:
        with self._lock:
            events = list(self._ring)
        return [e.to_dict() for e in events]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def __iter__(self) -> Iterator[Event]:
        with self._lock:
            return iter(list(self._ring))


__all__ = [
    "BudgetRebuild", "CorpusEvicted", "CorpusReadmitted", "Event",
    "EventLog", "IngestCrash", "QueryQuarantined", "TierTransition",
    "WorkerRestart",
]
