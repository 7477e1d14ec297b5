"""`repro_torch.obs` — dependency-free observability for the serving plane
(the counterpart of ``repro.obs``).

One :class:`Observability` bundle ties the three signal types together:

* ``obs.metrics`` — :class:`~repro_torch.obs.metrics.MetricsRegistry`
  (counters / gauges / bucketed histograms, Prometheus-exportable).
* ``obs.tracer`` — :class:`~repro_torch.obs.tracing.Tracer` minting
  per-query span timelines.
* ``obs.events`` — :class:`~repro_torch.obs.events.EventLog` ring of typed
  state-change events.

Each server owns its own bundle by default (pass ``obs=`` through
``ServerConfig`` / ``CorpusManager`` to share one across components); the
cold-start sentinel is NOT per-bundle — it watches the process-wide kernel
library table, so it lives as a process-wide singleton in
:mod:`repro_torch.obs.sentinel`.

Left out: the reference's ``jaxpr_collective_counts`` and the serve step's
``serve_step_collectives_*`` gauges it feeds; they describe the mesh
program, which the single-device port does not run.
"""

from __future__ import annotations

from repro_torch.obs import sentinel
from repro_torch.obs.events import (
    BudgetRebuild, CorpusEvicted, CorpusReadmitted, Event, EventLog,
    IngestCrash, QueryQuarantined, TierTransition, WorkerRestart,
)
from repro_torch.obs.metrics import (
    COUNT_BUCKETS, Counter, DEFAULT_BUCKETS, Gauge, Histogram,
    MetricsRegistry,
)
from repro_torch.obs.metrics import render_prometheus as _render_metrics
from repro_torch.obs.sentinel import RetraceError
from repro_torch.obs.tracing import (
    BatchTrace, QueryTrace, STAGES, Tracer, profiler_session,
)


class Observability:
    """Bundle of metrics + tracing + events with master switches.

    ``metrics_enabled`` / ``tracing_enabled`` gate each signal
    independently; a fully disabled bundle costs one attribute check per
    instrumentation site.
    """

    def __init__(self, *, metrics_enabled: bool = True,
                 tracing_enabled: bool = True, event_capacity: int = 1024):
        self.metrics = MetricsRegistry(enabled=metrics_enabled)
        self.tracer = Tracer(enabled=tracing_enabled)
        self.events = EventLog(maxlen=event_capacity)

    @property
    def enabled(self) -> bool:
        return self.metrics.enabled or self.tracer.enabled

    def snapshot(self) -> dict:
        """One JSON-able view: metrics + events + tracer counters +
        process-wide sentinel state."""
        return {
            "metrics": self.metrics.snapshot(),
            "events": self.events.snapshot(),
            "tracing": self.tracer.snapshot(),
            "sentinel": sentinel.snapshot(),
        }

    def render_prometheus(self) -> str:
        return _render_metrics(self.metrics)


#: Module default bundle, for callers that don't thread their own.
_DEFAULT = Observability()


def get_default() -> Observability:
    return _DEFAULT


def render_prometheus(obs: Observability | MetricsRegistry | None = None) -> str:
    """Text exposition of a bundle, a bare registry, or the default."""
    if obs is None:
        obs = _DEFAULT
    reg = obs.metrics if isinstance(obs, Observability) else obs
    return _render_metrics(reg)


__all__ = [
    "BatchTrace", "BudgetRebuild", "COUNT_BUCKETS",
    "CorpusEvicted", "CorpusReadmitted", "Counter", "DEFAULT_BUCKETS",
    "Event", "EventLog", "Gauge", "Histogram", "IngestCrash",
    "MetricsRegistry",
    "Observability", "QueryQuarantined", "QueryTrace", "RetraceError",
    "STAGES", "TierTransition", "Tracer", "WorkerRestart",
    "get_default", "profiler_session", "render_prometheus", "sentinel",
]
