"""Query serving front-ends over the LC-RWMD engine (the counterpart of
``repro.serving``).

:class:`QueryServer` is the synchronous reference server;
:class:`AsyncQueryServer` is the double-buffered pipeline (``submit`` →
:class:`ServeFuture`, host batching overlapped with the device serve, one
CUDA event per batch in flight).  The multi-process ingest pool
(:class:`IngestPool` + the zero-copy :class:`StagingRing`), the
degradation tiers, the typed error contract
(:mod:`repro_torch.serving.errors`) and the worker supervisor are the
reference's.  Deterministic fault injection lives in
:mod:`repro_torch.serving.faults`.

Observability: every server owns a :class:`repro_torch.obs.Observability`
bundle — metrics registry, request tracer, event log — exported via
``server.metrics_snapshot()`` (JSON) and ``server.obs.render_prometheus()``
(text exposition); the process-wide cold-start sentinel lives in
:mod:`repro_torch.obs.sentinel`.

Exports resolve LAZILY (PEP 562): spawned ingest-pool workers import
``repro_torch.serving.ingest_pool``, which triggers this package
``__init__`` — eager re-exports of the torch-backed server modules would
make every child pay the torch import before vectorizing its first query.
Only the numpy-only modules (``errors``, ``faults``, ``staging``,
``ingest_pool``) load in the children; ``query_server`` /
``corpus_manager`` / ``repro_torch.obs`` load on first attribute access in
the parent.
"""

_EXPORTS = {
    # numpy-only (safe in spawn children):
    "DeadlineExceeded": "repro_torch.serving.errors",
    "IngestCrashed": "repro_torch.serving.errors",
    "MeshDivergence": "repro_torch.serving.errors",
    "PoisonQuery": "repro_torch.serving.errors",
    "QueryRejected": "repro_torch.serving.errors",
    "ServerClosed": "repro_torch.serving.errors",
    "ServingError": "repro_torch.serving.errors",
    "WorkerCrashed": "repro_torch.serving.errors",
    "ALL": "repro_torch.serving.faults",
    "FaultInjector": "repro_torch.serving.faults",
    "FaultPlan": "repro_torch.serving.faults",
    "InjectedWorkerCrash": "repro_torch.serving.faults",
    "StagingRing": "repro_torch.serving.staging",
    "IngestPool": "repro_torch.serving.ingest_pool",
    # torch-backed (parent only):
    "DEFAULT_CORPUS": "repro_torch.serving.corpus_manager",
    "CorpusManager": "repro_torch.serving.corpus_manager",
    "CorpusState": "repro_torch.serving.corpus_manager",
    "IndexedCorpusState": "repro_torch.serving.corpus_manager",
    "Answer": "repro_torch.serving.query_server",
    "AsyncQueryServer": "repro_torch.serving.query_server",
    "DegradationController": "repro_torch.serving.query_server",
    "QueryServer": "repro_torch.serving.query_server",
    "ServeFuture": "repro_torch.serving.query_server",
    "ServerConfig": "repro_torch.serving.query_server",
    "Observability": "repro_torch.obs",
    "render_prometheus": "repro_torch.obs",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.serving' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value   # cache: subsequent lookups skip this hook
    return value


def __dir__():
    return __all__
