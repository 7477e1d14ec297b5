"""The port's ``AsyncQueryServer`` on the CPU: the pipeline, the typed error
contract, the supervisor and the ingest pool.

The servers run on ``ServerConfig(device="cpu")`` over the 256-doc corpus
of ``tests/test_torch_serving.py``.  On the CPU a dispatched batch is done
when its dispatch returns (no CUDA event), so the pipeline's order and
overlap are what is tested here; the card tests in
``tests/test_torch_cuda.py`` hold the events.  Answers of the async server
must equal the sync server's bit for bit (the same chunks of ``max_batch``
reach the same plain versions), and so must the ingest pool's the
in-thread path's.
"""

import subprocess
import sys

import numpy as np
import pytest

from repro_torch.data.vectorizer import VocabVectorizer
from repro_torch.serving import (
    Answer,
    AsyncQueryServer,
    DeadlineExceeded,
    FaultPlan,
    PoisonQuery,
    QueryRejected,
    QueryServer,
    ServerClosed,
    ServerConfig,
    ServingError,
    WorkerCrashed,
)
from test_torch_serving import H, K, corpus, stream_of  # noqa: F401

VOCAB = 1024


def cfg(**kw):
    base = dict(k=K, max_batch=8, h_max=H, max_wait_s=5.0, device="cpu")
    base.update(kw)
    return ServerConfig(**base)


def outcomes(futs, timeout=60):
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=timeout))
        except ServingError as e:
            out.append(e)
    return out


def run_async(server, payloads):
    """Submit everything, drain; (outcomes, completion order)."""
    done = []
    futs = []
    for i, p in enumerate(payloads):
        f = server.submit(*p) if isinstance(p, tuple) else server.submit(p)
        f.add_done_callback(lambda _f, i=i: done.append(i))
        futs.append(f)
    server.drain()
    return outcomes(futs), done


@pytest.mark.timeout(300)
def test_async_equals_sync_in_order_with_overlap(corpus):
    c, docs, emb = corpus
    stream, picks = stream_of(c, n=40, seed=2)
    kw = dict(refine_symmetric=True)
    sync = QueryServer(docs, emb, cfg(**kw))
    for q in stream:
        sync.submit(*q)
    want = sync.flush()
    with AsyncQueryServer(docs, emb, cfg(**kw)) as server:
        server._core.trace = []
        got, done = run_async(server, stream)
        trace = list(server._core.trace)
    assert done == list(range(len(stream)))           # submission order
    for g, w, p in zip(got, want, picks):
        assert isinstance(g, Answer) and g.tier == 0 and g[0][0] == p
        assert g[0].tobytes() == w[0].tobytes()
        assert g[1].tobytes() == w[1].tobytes()
    pos = {e: j for j, e in enumerate(trace)}
    n_batches = len(stream) // 8
    assert all(pos[("dispatch", i + 1)] < pos[("collect", i)]
               for i in range(n_batches - 1))


@pytest.mark.timeout(300)
def test_deadlines_and_admission(corpus):
    c, docs, emb = corpus
    stream, _ = stream_of(c, n=4, seed=9)
    plan = FaultPlan(latency_s={0: 0.25})
    with AsyncQueryServer(docs, emb, cfg(), faults=plan) as server:
        with pytest.raises(QueryRejected):
            server.submit(*stream[0], deadline=-0.5)
        with pytest.raises(PoisonQuery):
            server.submit(stream[0][0], np.zeros(H, np.float32))
        with pytest.raises(QueryRejected, match="unknown corpus"):
            server.submit(*stream[0], corpus_id="nope")
        f_late = server.submit(*stream[0], deadline=0.05)
        f_fine = server.submit(*stream[1])
        server.flush()
        server.drain()
        with pytest.raises(DeadlineExceeded):
            f_late.result(timeout=30)
        assert isinstance(f_fine.result(timeout=30), Answer)
        assert server.stats["deadline_misses"] == 1
    with pytest.raises(ServerClosed):
        server.submit(*stream[0])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("mode", ["restart", "give_up"])
def test_supervisor(corpus, mode):
    """An injected worker crash fails its batch with WorkerCrashed and the
    loop restarts in submission order; past max_worker_restarts the server
    closes and fails the rest with ServerClosed."""
    c, docs, emb = corpus
    n = 16 if mode == "restart" else 24
    stream, picks = stream_of(c, n=n, seed=5)
    crashes = (0,) if mode == "restart" else (0, 1, 2)
    server = AsyncQueryServer(docs, emb, cfg(pipeline_depth=1,
                                             max_worker_restarts=1),
                              faults=FaultPlan(crash_batches=crashes))
    try:
        got, done = run_async(server, stream)
        health = server.health()
    finally:
        server.close(timeout=10)
    assert all(isinstance(g, WorkerCrashed) for g in got[:8])
    assert all(g.__cause__ is not None for g in got[:8])
    if mode == "restart":
        assert [g[0][0] for g in got[8:]] == list(picks[8:])
        assert done == list(range(n))
        assert health["worker_alive"] and health["worker_restarts"] == 1
    else:
        assert sum(isinstance(g, WorkerCrashed) for g in got) == 16
        assert sum(isinstance(g, ServerClosed) for g in got) == 8
        assert not health["worker_alive"] and health["closed"]


@pytest.mark.timeout(300)
def test_cuda_error_closes_the_server(corpus):
    """A CUDA error that leaves the context unusable is not restarted: its
    batch fails with WorkerCrashed, every other unresolved future with
    ServerClosed, and close() returns."""
    c, docs, emb = corpus
    stream, _ = stream_of(c, n=24, seed=6)
    server = AsyncQueryServer(docs, emb, cfg(pipeline_depth=1))
    inner, calls = server._serve, []

    def faulty(queries, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        return inner(queries, *a, **kw)

    server._serve = faulty
    futs = [server.submit(*q) for q in stream]
    got = outcomes(futs)
    server.close(timeout=10)
    assert all(isinstance(g, Answer) for g in got[:8])
    assert all(isinstance(g, WorkerCrashed) for g in got[8:16])
    assert all(isinstance(g, ServerClosed) for g in got[16:])
    assert server.health()["closed"] and not server.health()["worker_alive"]
    assert len(calls) == 2                  # nothing re-ran elsewhere


def _vectorizer():
    """Tokens ``w<id>`` map back to word id ``<id>``."""
    return VocabVectorizer(h_max=H).fit(
        [" ".join(f"w{i}" for i in range(VOCAB))])


def _as_text(ids, w):
    """A resident histogram as text: each word repeated by its weight."""
    return " ".join(" ".join([f"w{i}"] * max(1, round(float(x) * 32)))
                    for i, x in zip(ids, w) if x > 0)


@pytest.mark.timeout(300)
def test_ingest_pool_matches_in_thread(corpus):
    """ingest_workers=2 (spawned processes, the port's picklable
    VocabVectorizer) against the in-thread path on the same texts: the
    answers bit for bit, futures in submission order."""
    c, docs, emb = corpus
    stream, _ = stream_of(c, n=24, seed=8)
    texts = [_as_text(*q) for q in stream]
    vec = _vectorizer()
    ids0, w0 = vec.query_histogram(texts[0])
    assert set(ids0[w0 > 0]) == set(stream[0][0][stream[0][1] > 0])

    def run(workers):
        with AsyncQueryServer(docs, emb, cfg(ingest_workers=workers,
                                             staging_slots=16),
                              preprocess=vec.query_histogram) as server:
            got, done = run_async(server, texts)
            return got, done, server.health()

    pooled, done_p, health = run(2)
    inthread, done_t, _ = run(0)
    assert done_p == done_t == list(range(len(texts)))
    for p, t in zip(pooled, inthread):
        assert p[0].tobytes() == t[0].tobytes()
        assert p[1].tobytes() == t[1].tobytes()
    pool = health["ingest_pool"]
    assert pool["workers"] == pool["alive"] == 2
    assert pool["submitted"] == pool["collected"] == len(texts)


def test_spawned_child_imports_no_torch():
    """A spawned child that imports the ingest pool and the vectorizers
    (what an ingest worker imports) has no torch, jax or repro module."""
    code = (
        "import multiprocessing as mp\n"
        "probe = ('import sys, repro_torch.serving.ingest_pool, '\n"
        "         'repro_torch.data.vectorizer\\n'\n"
        "         'q.put(sorted(m for m in sys.modules if m.split(\".\")[0] '\n"
        "         'in (\"torch\", \"jax\", \"repro\")))')\n"
        "if __name__ == '__main__':\n"
        "    ctx = mp.get_context('spawn')\n"
        "    q = ctx.Queue()\n"
        "    p = ctx.Process(target=exec, args=(probe, {'q': q}))\n"
        "    p.start()\n"
        "    print(q.get(timeout=60))\n"
        "    p.join(60)\n"
        "    assert p.exitcode == 0\n")
    import pathlib
    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]", r.stdout


@pytest.mark.timeout(300)
def test_concurrent_producers_resolve_every_future(corpus):
    """Eight producer threads submitting at once, with the interpreter
    switching threads as often as it can: every future resolves with its
    own query's answer and the counters add up."""
    import threading

    c, docs, emb = corpus
    stream, picks = stream_of(c, n=128, seed=11)
    out = [None] * len(stream)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with AsyncQueryServer(docs, emb, cfg(max_wait_s=0.005,
                                             queue_capacity=16)) as server:
            def produce(lo):
                for j in range(lo, len(stream), 8):
                    out[j] = server.submit(*stream[j])

            threads = [threading.Thread(target=produce, args=(t,))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            got = outcomes(out)
            server.drain()
            health = server.health()
    finally:
        sys.setswitchinterval(old)
    assert [a[0][0] for a in got] == list(picks)
    assert health["unanswered"] == 0 and health["queries"] == len(stream)
    assert server.stats_snapshot()["queries"] == len(stream)
