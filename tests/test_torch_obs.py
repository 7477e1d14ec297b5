"""The port's observability bundle on the CPU: metric names against the
reference's after the same traffic, the copied registry and its text
format, the cold-start sentinel, request traces and the profiler session.

Metric names are compared as sets after the same requests reach the
port's server (``device="cpu"``) and the reference's (``make_host_mesh()``);
the reference's ``serve_step_collectives_*`` gauges describe its mesh
program and are the only names the port does not have.
"""

import json

import numpy as np
import pytest

from repro.launch.mesh import make_host_mesh
from repro.obs import metrics as jmetrics
from repro.serving import query_server as jqs
from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch.obs import STAGES, Observability, metrics, profiler_session
from repro_torch.obs import sentinel
from repro_torch.serving import query_server as tqs
from repro_torch.serving.faults import FaultPlan
from test_torch_serving import H, K, corpus, stream_of  # noqa: F401
from test_torch_segments import RERANK_KW

COLLECTIVE = "serve_step_collectives_"


def _port_index_cfg(**kw):
    from repro_torch.index import IndexConfig
    return IndexConfig(**kw)


def _ref_index_cfg(**kw):
    from repro.index import IndexConfig
    return IndexConfig(**kw)


TRAFFIC = {
    # the full cascade with an adaptive budget, a poisoned query and a
    # transient NaN batch, degradation on
    "rerank_faults": dict(
        kw=dict(rerank_wmd=True, wmd_kw=RERANK_KW, adaptive_budget=True,
                degradation=True, fail_streak_down=1),
        faults=lambda stream: dict(nan_batches={1: "all"},
                                   poison_word_id=int(stream[5][0][0]))),
    # routed through an index whose probe cap overflows, bound on
    "indexed": dict(kw=dict(index="cells"), faults=None),
}


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
@pytest.mark.parametrize("server", ["sync", "async"])
def test_metric_names_match_reference(corpus, traffic, server):
    c, docs, emb = corpus
    spec = TRAFFIC[traffic]
    stream, _ = stream_of(c, seed=4)
    faults = spec["faults"](stream) if spec["faults"] else None
    base = dict(k=K, max_batch=8, h_max=H, max_wait_s=5.0)
    base.update(spec["kw"])
    icfg = dict(num_cells=8, top_p=3, probe_cap=4, bound_slack=1.0)
    pkw, rkw = dict(base), dict(base)
    if base.get("index"):
        pkw["index"], rkw["index"] = (_port_index_cfg(**icfg),
                                      _ref_index_cfg(**icfg))
    cls = "AsyncQueryServer" if server == "async" else "QueryServer"
    port = getattr(tqs, cls)(docs, emb, tqs.ServerConfig(device="cpu", **pkw),
                             faults=faults and FaultPlan(**faults))
    ref = getattr(jqs, cls)(c.docs, c.emb, make_host_mesh(),
                            jqs.ServerConfig(**rkw),
                            faults=faults and JFaultPlan(**faults))
    for s in (port, ref):
        futs = [s.submit(*q) for q in stream]
        if server == "async":
            s.drain()
            for f in futs:
                f.exception(timeout=60)
            s.close()
        else:
            s.flush()
    mine = set(port.metrics_snapshot()["metrics"])
    theirs = {n for n in ref.metrics_snapshot()["metrics"]
              if not n.startswith(COLLECTIVE)}
    assert mine == theirs, (mine ^ theirs)
    text = port.obs.render_prometheus()
    assert all(f"# TYPE {n} " in text for n in mine)
    json.dumps(port.metrics_snapshot())            # JSON-able as a whole
    if traffic == "indexed":
        assert {"index_cells_probed", "index_routed_fraction",
                "index_probe_overflow_total"} <= mine


def test_registry_text_is_the_references():
    """The same records render the same Prometheus text and snapshot."""
    regs = (metrics.MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("a_total", "a counter").inc(3)
        reg.gauge("g", "a gauge", labels={"x": "1"}).set(0.25)
        h = reg.histogram("h_seconds", "a histogram", labels={"v": "seg"})
        for v in (1e-5, 3e-4, 0.02, 7.0, 1e3):
            h.observe(v)
        reg.histogram("n", "counts", buckets=metrics.COUNT_BUCKETS).observe(5)
    assert metrics.render_prometheus(regs[0]) == jmetrics.render_prometheus(
        regs[1])
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.fixture
def clean_sentinel():
    sentinel.reset()
    yield sentinel.get_sentinel()
    sentinel.reset()


def test_sentinel_classifies_library_loads(clean_sentinel):
    s = clean_sentinel
    sentinel.note_load("spmm_ell", built=True)     # warm-up: legitimate
    sentinel.check()
    sentinel.arm()
    with sentinel.expect("adaptive budget rebuild"):
        sentinel.note_load("sinkhorn_wmd")
    sentinel.check()
    step = sentinel.wrap("serve", lambda n: sentinel.note_load("fused_topk")
                         if n else None)
    step(0)
    step(1)                                         # a load while armed
    snap = sentinel.snapshot()
    assert snap["builds"] == 1 and snap["armed"]
    assert snap["loads"]["serve"] == 1
    assert [u["kind"] for u in snap["unexpected"]] == ["load-while-armed"]
    with pytest.raises(sentinel.RetraceError, match="fused_topk"):
        sentinel.check()
    s.strict = True
    try:
        with pytest.raises(sentinel.RetraceError):
            sentinel.note_load("rwmd_pairwise")
    finally:
        s.strict = False


def test_sentinel_silent_across_a_warm_cpu_run(corpus, clean_sentinel):
    """On the CPU no library loads at all, budget rebuilds and tier
    switches included (the card test holds the same after warm-up)."""
    c, docs, emb = corpus
    server = tqs.QueryServer(docs, emb, tqs.ServerConfig(
        k=K, max_batch=8, h_max=H, device="cpu", rerank_wmd=True,
        wmd_kw=RERANK_KW, adaptive_budget=True, degradation=True,
        fail_streak_down=1), faults=FaultPlan(nan_batches={1: "all"}))
    stream, _ = stream_of(c, seed=6)
    sentinel.arm()
    for q in stream:
        server.submit(*q)
    answers = server.flush()
    assert {a.tier for a in answers} == {0, 1}
    assert server.stats["budget_rebuilds"] >= 1
    sentinel.check()
    assert server.metrics_snapshot()["sentinel"]["armed"]


@pytest.mark.parametrize("server", ["sync", "async"])
def test_answers_carry_complete_traces(corpus, server):
    c, docs, emb = corpus
    stream, _ = stream_of(c, n=10, seed=7)
    cfg = tqs.ServerConfig(k=K, max_batch=8, h_max=H, device="cpu")
    if server == "sync":
        s = tqs.QueryServer(docs, emb, cfg)
        for q in stream:
            s.submit(*q)
        traces = [a.trace for a in s.flush()]
    else:
        with tqs.AsyncQueryServer(docs, emb, cfg) as s:
            futs = [s.submit(*q) for q in stream]
            s.drain()
            traces = [f.result(timeout=30) and f.trace for f in futs]
    for tr in traces:
        names = [name for name, _, _ in tr.timeline()]
        assert set(names) == set(STAGES) and tr.done
        d = tr.to_dict()
        assert all(sp["duration_s"] >= 0 for sp in d["spans"])
    assert {t.batch.seq for t in traces} == {0, 1}


def test_profiler_session_writes_a_chrome_trace(tmp_path):
    import torch

    with profiler_session(str(tmp_path)):
        torch.ones(64).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_disabled_bundle_records_nothing(corpus):
    c, docs, emb = corpus
    obs = Observability(metrics_enabled=False, tracing_enabled=False)
    s = tqs.QueryServer(docs, emb, tqs.ServerConfig(
        k=K, max_batch=8, h_max=H, device="cpu", obs=obs))
    stream, _ = stream_of(c, n=8)
    for q in stream:
        s.submit(*q)
    answers = s.flush()
    assert all(a.trace is None for a in answers)
    snap = obs.snapshot()
    assert all(ch.get("value", 0) == 0 and ch.get("count", 0) == 0
               for fam in snap["metrics"].values() for ch in fam["series"])
    assert np.all([a[0][0] >= 0 for a in answers])
