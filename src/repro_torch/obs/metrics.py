"""Dependency-free metrics registry: counters, gauges, log-bucket histograms
(the port's copy of ``repro.obs.metrics``: the same names, buckets and text
format).

Prometheus-shaped but self-contained (the serving plane must not grow a
dependency for visibility):

* :class:`Counter` — monotone float, ``inc(n)``.
* :class:`Gauge` — last-write-wins float, ``set(v)`` / ``inc(n)``.
* :class:`Histogram` — FIXED log-spaced bucket boundaries, cumulative
  counts only: ``observe(v)`` is O(log buckets) and the histogram never
  stores samples, so p50/p95/p99 come from bucket interpolation with
  bounded error (one bucket width) at O(1) memory — the property that
  makes per-request latency tracking safe on the serve hot path.

All mutation goes through one registry-level lock held only for the
python-dict update (never across device work), so concurrent
submit/collect threads see consistent snapshots.  With
``registry.enabled = False`` every record call returns after ONE attribute
check — the serving plane's overhead leans on that fast path.

Export surfaces: :meth:`MetricsRegistry.snapshot` (plain JSON-able dict)
and :func:`render_prometheus` (text exposition format, `# TYPE`/`# HELP`
comments + ``_bucket``/``_sum``/``_count`` histogram series).
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Iterable, Mapping

#: Default latency buckets: log-spaced (factor 2) upper bounds from 1 µs to
#: ~67 s — 27 buckets cover every serve-path duration this repo has ever
#: recorded (3.5 ms flushes to 100 ms re-trace pathologies) with <2x
#: quantile error.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(1e-6 * 2.0**i for i in range(27))

#: Buckets for small integer-ish distributions (batch sizes, counts).
COUNT_BUCKETS: tuple[float, ...] = tuple(float(2**i) for i in range(11))


def _label_key(labels: Mapping[str, str] | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base child metric: one (name, labelset) time series."""

    __slots__ = ("_reg", "name", "labels")

    kind = "untyped"

    def __init__(self, reg: "MetricsRegistry", name: str,
                 labels: Mapping[str, str] | None):
        self._reg = reg
        self.name = name
        self.labels = dict(labels or {})


class Counter(_Metric):
    __slots__ = ("value",)

    kind = "counter"

    def __init__(self, reg, name, labels):
        super().__init__(reg, name, labels)
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self.value += n


class Gauge(_Metric):
    __slots__ = ("value",)

    kind = "gauge"

    def __init__(self, reg, name, labels):
        super().__init__(reg, name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self.value += n


class Histogram(_Metric):
    """Cumulative-bucket histogram over fixed log-spaced boundaries.

    ``bounds`` are inclusive upper edges; one implicit +inf overflow bucket
    catches everything beyond the last edge.  Quantiles interpolate
    linearly inside the winning bucket (Prometheus ``histogram_quantile``
    semantics), so the error is bounded by one bucket width — with the
    factor-2 default, a reported p99 is within 2x of the true p99, which
    is the right fidelity/cost point for always-on serving telemetry.
    """

    __slots__ = ("bounds", "counts", "total", "sum")

    kind = "histogram"

    def __init__(self, reg, name, labels, bounds: Iterable[float]):
        super().__init__(reg, name, labels)
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: +inf overflow
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        v = float(v)
        idx = bisect.bisect_left(self.bounds, v)
        with reg._lock:
            self.counts[idx] += 1
            self.total += 1
            self.sum += v

    def percentile(self, p: float) -> float:
        """Estimate the p-quantile (p in [0, 1]) from bucket counts."""
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        with self._reg._lock:
            total = self.total
            counts = list(self.counts)
        if total == 0:
            return float("nan")
        rank = p * total
        cum = 0.0
        for i, c in enumerate(counts):
            if cum + c >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else math.inf
                if not math.isfinite(hi):
                    return lo  # overflow bucket: report its lower edge
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return self.bounds[-1]


class MetricsRegistry:
    """Thread-safe metric family registry with a process-cheap fast path.

    ``counter`` / ``gauge`` / ``histogram`` return the (name, labels)
    child, creating it on first use — repeat calls with the same identity
    return the SAME object, so hot paths can either cache the handle or
    re-look it up (one dict get under the lock).  ``help`` text is stored
    per family on first registration.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        # name -> {"kind": str, "help": str, "children": {labelkey: child}}
        self._families: dict[str, dict] = {}

    # -- registration ------------------------------------------------------
    def _child(self, cls, name: str, help: str,
               labels: Mapping[str, str] | None, **kw):
        lk = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"kind": cls.kind, "help": help, "children": {}}
                self._families[name] = fam
            elif fam["kind"] != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam['kind']}")
            child = fam["children"].get(lk)
            if child is None:
                child = cls(self, name, labels, **kw)
                fam["children"][lk] = child
            return child

    def counter(self, name: str, help: str = "",
                labels: Mapping[str, str] | None = None) -> Counter:
        return self._child(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Mapping[str, str] | None = None) -> Gauge:
        return self._child(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Mapping[str, str] | None = None,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._child(Histogram, name, help, labels, bounds=buckets)

    # -- export ------------------------------------------------------------
    def snapshot(self) -> dict:
        """One consistent JSON-able view of every registered series.

        Counters/gauges export their value; histograms export count, sum,
        and interpolated p50/p95/p99 (the common operator questions) plus
        the raw cumulative buckets for offline analysis.
        """
        with self._lock:
            fams = {
                name: {
                    "kind": fam["kind"],
                    "help": fam["help"],
                    "children": list(fam["children"].values()),
                }
                for name, fam in self._families.items()
            }
            out: dict = {}
            for name, fam in fams.items():
                series = []
                for ch in fam["children"]:
                    entry: dict = {"labels": dict(ch.labels)}
                    if fam["kind"] == "histogram":
                        entry.update(
                            count=ch.total, sum=ch.sum,
                            buckets={
                                ("+Inf" if i == len(ch.bounds)
                                 else repr(ch.bounds[i])): c
                                for i, c in enumerate(ch.counts)},
                        )
                    else:
                        entry["value"] = ch.value
                    series.append(entry)
                out[name] = {"kind": fam["kind"], "help": fam["help"],
                             "series": series}
        # Percentiles take the lock per histogram; compute them outside the
        # snapshot lock to keep its critical section dict-copy-short.
        for name, fam in out.items():
            if fam["kind"] != "histogram":
                continue
            for entry, ch in zip(fam["series"],
                                 self._families[name]["children"].values()):
                entry["p50"] = ch.percentile(0.50)
                entry["p95"] = ch.percentile(0.95)
                entry["p99"] = ch.percentile(0.99)
        return out


def _fmt_labels(labels: Mapping[str, str], extra: Mapping[str, str] | None = None
                ) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def _fmt_val(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (v0.0.4) of one registry.

    Histograms render the standard cumulative ``_bucket{le=...}`` series
    (including ``le="+Inf"``) plus ``_sum``/``_count``, so the output
    scrapes directly into any Prometheus-compatible collector.
    """
    lines: list[str] = []
    with registry._lock:
        fams = {name: (fam["kind"], fam["help"],
                       list(fam["children"].values()))
                for name, fam in registry._families.items()}
    for name in sorted(fams):
        kind, help_, children = fams[name]
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for ch in children:
            if kind == "histogram":
                cum = 0
                with registry._lock:
                    counts = list(ch.counts)
                    total, sum_ = ch.total, ch.sum
                for i, c in enumerate(counts):
                    cum += c
                    le = ("+Inf" if i == len(ch.bounds)
                          else _fmt_val(ch.bounds[i]))
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(ch.labels, {'le': le})} {cum}")
                lines.append(f"{name}_sum{_fmt_labels(ch.labels)} "
                             f"{_fmt_val(sum_)}")
                lines.append(f"{name}_count{_fmt_labels(ch.labels)} {total}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(ch.labels)} {_fmt_val(ch.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


__all__ = [
    "COUNT_BUCKETS", "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram",
    "MetricsRegistry", "render_prometheus",
]
