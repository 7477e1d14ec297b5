"""The port's synchronous ``QueryServer`` against the reference's, on the CPU.

The reference serves on ``make_host_mesh()`` (one device), the port on
``ServerConfig(device="cpu")`` (each kernel's plain version), both over
the same 256-doc corpus (``tests/test_serving.py``'s spec) and the same
stream of resident docs' own histograms, submitted and flushed in chunks
of ``max_batch``.

Tolerances: distances within ``assert_topk_close``'s (1e-4 relative,
2.5e-2 absolute: the gram form's noise near zero), ids equal wherever both
neighbouring gaps exceed that.  With the WMD rerank, the final ids are
compared on the queries whose one-sided candidate sets agree (at least
three quarters of them), at ``test_torch_segments.RERANK_KW``, where the
two Sinkhorn backends agree.  Tier stamps and the stats counters under
the same ``FaultPlan`` must be equal; ``pad_batch`` and the vectorizers
bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

from repro.data.synth import CorpusSpec, make_corpus
from repro.launch.mesh import make_host_mesh
from repro.serving import query_server as jqs
from repro.serving import staging as jstaging
from repro.serving.faults import FaultPlan as JFaultPlan
from repro_torch.convert import from_numpy
from repro_torch.serving import query_server as tqs
from repro_torch.serving import staging as tstaging
from repro_torch.serving.errors import PoisonQuery
from repro_torch.serving.faults import FaultPlan
from test_torch_engine import assert_topk_close
from test_torch_segments import RERANK_KW

K = 5
MAX_BATCH = 8
H = 12
N_QUERIES = 24


@pytest.fixture(scope="module")
def corpus():
    c = make_corpus(CorpusSpec(n_docs=256, vocab_size=1024, emb_dim=32,
                               h_max=H, mean_h=8.0, n_classes=4, seed=11))
    docs, emb = from_numpy(np.asarray(c.docs.ids), np.asarray(c.docs.weights),
                           c.emb, device="cpu")
    return c, docs, emb


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def stream_of(c, n=N_QUERIES, seed=0):
    ids, w = np.asarray(c.docs.ids), np.asarray(c.docs.weights)
    picks = np.random.default_rng(seed).integers(0, c.docs.n_docs, n)
    return [(ids[i], w[i]) for i in picks], picks


def serve_all(server, stream):
    """Submit the whole stream, flush once: chunks of max_batch."""
    for q in stream:
        server.submit(*q)
    return server.flush()


def pair(corpus, mesh, *, faults=None, **kw):
    """(port server, reference server) at the same configuration."""
    c, docs, emb = corpus
    base = dict(k=K, max_batch=MAX_BATCH, h_max=H)
    base.update(kw)
    port = tqs.QueryServer(docs, emb, tqs.ServerConfig(device="cpu", **base),
                           faults=None if faults is None else FaultPlan(**faults))
    ref = jqs.QueryServer(c.docs, c.emb, mesh, jqs.ServerConfig(**base),
                          faults=None if faults is None else
                          JFaultPlan(**faults))
    return port, ref


def _topk(d, i):
    from repro_torch.core.topk import TopK
    return TopK(torch.as_tensor(d), torch.as_tensor(i))


STATS = ("queries", "batches", "tier_counts", "poisoned_queries",
         "validation_failures", "validation_retries", "degraded_batches",
         "wmd_reranks")


# ---------------------------------------------------------------------------
# Answers, tier stamps and stats against the reference
# ---------------------------------------------------------------------------
CASES = {
    # the refined LC-RWMD cascade (tier 0 without the rerank)
    "refine": dict(kw=dict(refine_symmetric=True)),
    # refine + the Sinkhorn-WMD rerank at a fixed budget of 2k
    "rerank": dict(kw=dict(refine_symmetric=True, rerank_wmd=True,
                           wmd_kw=RERANK_KW)),
    # two poisoned batches step the tier down: batches at tiers 0, 1 and 2
    "degraded": dict(kw=dict(degradation=True, recover_after=2,
                             fail_streak_down=1),
                     faults=dict(nan_batches={0: "all", 1: [2, 5]})),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_server_answers_match_reference(corpus, mesh, case):
    c, docs, _ = corpus
    spec = CASES[case]
    port, ref = pair(corpus, mesh, faults=spec.get("faults"), **spec["kw"])
    stream, picks = stream_of(c)
    got, want = serve_all(port, stream), serve_all(ref, stream)
    assert len(got) == len(want) == N_QUERIES
    assert [a.tier for a in got] == [a.tier for a in want]
    assert all(picks[j] == a[0][0] for j, a in enumerate(got))  # self first
    rows = np.arange(N_QUERIES)
    if spec["kw"].get("rerank_wmd"):
        # candidates: the one-sided top-2k that reaches the rerank
        from repro_torch.data.docs import DocSet
        q = DocSet(ids=docs.ids[torch.as_tensor(picks)],
                   weights=docs.weights[torch.as_tensor(picks)])
        mine = port.engine.topk_streaming(q, 2 * K).indices.numpy()
        theirs = np.asarray(ref.engine.topk_streaming(c.docs[picks], 2 * K)
                            .indices)
        agree = np.array([set(a) == set(b) for a, b in zip(mine, theirs)])
        assert agree.mean() >= 0.75, agree
        rows = rows[agree]
    assert_topk_close(
        _topk(np.stack([got[j][1] for j in rows]),
              np.stack([got[j][0] for j in rows])),
        _topk(np.stack([want[j][1] for j in rows]),
              np.stack([want[j][0] for j in rows])))
    g, w = port.stats_snapshot(), ref.stats_snapshot()
    assert {s: g[s] for s in STATS} == {s: w[s] for s in STATS}
    assert g["tier_transitions"] == w["tier_transitions"]


def test_stats_under_faultplan_match_reference(corpus, mesh):
    """A transient NaN batch and a sticky poison query: the same queries
    fail, with the same counters."""
    c, _, _ = corpus
    stream, _ = stream_of(c, seed=3)
    faults = dict(nan_batches={1: "all"}, poison_word_id=int(stream[11][0][0]))
    port, ref = pair(corpus, mesh, faults=faults)
    got, want = serve_all(port, stream), serve_all(ref, stream)
    bad = [j for j, a in enumerate(got) if isinstance(a, Exception)]
    assert bad == [j for j, a in enumerate(want) if isinstance(a, Exception)]
    assert 11 in bad and all(isinstance(got[j], PoisonQuery) for j in bad)
    g, w = port.stats_snapshot(), ref.stats_snapshot()
    assert g["poisoned_queries"] == len(bad) >= 1
    assert {s: g[s] for s in STATS} == {s: w[s] for s in STATS}
    for j in range(N_QUERIES):
        if j not in bad:
            np.testing.assert_array_equal(got[j][0][:1], want[j][0][:1])


def test_budget_trajectory_matches_reference(corpus, mesh):
    """The adaptive rerank budget sees the same pruned_exact flags and
    takes the same steps (grows, then decays after one exact batch)."""
    c, _, _ = corpus
    port, ref = pair(corpus, mesh, rerank_wmd=True, wmd_kw=RERANK_KW,
                     adaptive_budget=True, budget_decay_after=1, k=4)
    stream, _ = stream_of(c, n=32, seed=5)
    serve_all(port, stream), serve_all(ref, stream)
    g, w = port.stats_snapshot(), ref.stats_snapshot()
    assert g["budget_trajectory"] == w["budget_trajectory"]
    assert g["budget_rebuilds"] == w["budget_rebuilds"]
    b, rb = port.budget, ref.budget
    assert (b.budget, b.exact_streak, b.failed_budget) == (
        rb.budget, rb.exact_streak, rb.failed_budget)
    # the obs bundle is plumbing: dataclass equality ignores it
    bare = copy.copy(b)
    bare.obs = None
    assert b.obs is port.obs and bare == b


def test_overflow_chunked_by_max_batch(corpus):
    """> max_batch pending queries flush as chunks of at most max_batch,
    each at its real query count (no padded query rows)."""
    c, docs, emb = corpus
    server = tqs.QueryServer(docs, emb, tqs.ServerConfig(
        k=K, max_batch=MAX_BATCH, h_max=H, device="cpu"))
    shapes = []
    inner = server._serve

    def spy(queries):
        shapes.append(tuple(queries.ids.shape))
        return inner(queries)

    server._serve = spy
    stream, picks = stream_of(c, n=21, seed=3)
    answers = serve_all(server, stream)
    assert len(answers) == 21 and server.stats["batches"] == 3
    assert shapes == [(8, H), (8, H), (5, H)]
    assert all(p == a[0][0] for p, a in zip(picks, answers))


def test_serve_stream_flushes_pending_on_input_error(corpus):
    c, docs, emb = corpus
    server = tqs.QueryServer(docs, emb, tqs.ServerConfig(
        k=K, max_batch=MAX_BATCH, h_max=H, max_wait_s=10.0, device="cpu"))
    stream, picks = stream_of(c, n=5, seed=13)

    def dying():
        yield from stream
        raise RuntimeError("ingest connection lost")

    got = []
    with pytest.raises(RuntimeError, match="ingest connection lost"):
        for a in server.serve_stream(dying()):
            got.append(a)
    assert [a[0][0] for a in got] == list(picks)
    assert server.stats["stream_failures"] == 1


# ---------------------------------------------------------------------------
# Host prep and the vectorizers, bit for bit
# ---------------------------------------------------------------------------
def _histograms(seed, n, h, *, long=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        m = int(rng.integers(1, (2 * h if long else h) + 1))
        ids = rng.choice(4096, size=m, replace=False).astype(np.int32)
        ids[rng.random(m) < 0.1] = -1                # padding convention
        w = rng.random(m).astype(np.float32)
        if rng.random() < 0.3:
            w = (w / w.sum()).astype(np.float32)     # already normalized
        out.append((ids, w))
    return out


@pytest.mark.parametrize("case", ["plain", "truncated", "partial", "restaged"])
def test_pad_batch_bit_equal_to_reference(case):
    h = 16
    qs = _histograms({"plain": 1, "truncated": 2, "partial": 3,
                      "restaged": 4}[case], 7, h, long=case == "truncated")
    max_batch = 12 if case == "partial" else 7
    ids, w = tstaging.pad_batch(qs, max_batch, h)
    want = jstaging.pad_batch(qs, max_batch, h)
    assert ids.dtype == np.int32 and w.dtype == np.float32
    np.testing.assert_array_equal(ids, np.asarray(want.ids))
    assert w.tobytes() == np.asarray(want.weights).tobytes()
    if case == "restaged":   # idempotence: the staging ring re-pads rows
        ids2, w2 = tstaging.pad_batch(list(zip(ids, w)), max_batch, h)
        np.testing.assert_array_equal(ids2, ids)
        assert w2.tobytes() == w.tobytes()


TEXTS = ["the quick brown fox jumps over the lazy dog",
         "a fox and a dog were friends in the forest near the river",
         "stock markets fell as the bank raised rates again this week",
         "rates rose; markets fell; the dog slept through all of it",
         "forest river fox dog bank market rate week quick lazy brown"]


@pytest.mark.parametrize("kind", ["hashing", "vocab"])
def test_vectorizers_bit_equal_to_reference(kind):
    from repro.data import vectorizer as jv
    from repro_torch.data import vectorizer as tv

    if kind == "hashing":
        mine, theirs = tv.HashingVectorizer(n_features=4096, h_max=8), \
            jv.HashingVectorizer(n_features=4096, h_max=8)
    else:
        mine = tv.VocabVectorizer(h_max=8).fit(TEXTS[:3])
        theirs = jv.VocabVectorizer(h_max=8).fit(TEXTS[:3])
        assert mine.vocab == theirs.vocab
    for t in TEXTS:
        for a, b in zip(mine.query_histogram(t), theirs.query_histogram(t)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    ds = (mine.corpus_to_docset(TEXTS, device="cpu") if kind == "hashing"
          else mine.transform(TEXTS, device="cpu"))
    want = (theirs.corpus_to_docset(TEXTS) if kind == "hashing"
            else theirs.transform(TEXTS))
    np.testing.assert_array_equal(ds.ids.numpy(), np.asarray(want.ids))
    assert ds.weights.numpy().tobytes() == np.asarray(want.weights).tobytes()
    with pytest.raises(PoisonQuery):
        mine.query_histogram("the and of to")       # stop words only


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
@pytest.mark.parametrize("entry", ["QueryServer", "AsyncQueryServer",
                                   "CorpusManager"])
def test_entry_points_raise_without_a_card(corpus, entry):
    """device=None means the card; there is no quiet move to the CPU."""
    from repro_torch.serving.corpus_manager import CorpusManager

    _, docs, emb = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "CorpusManager":
            CorpusManager(emb)
        else:
            getattr(tqs, entry)(docs, emb, tqs.ServerConfig(k=K, h_max=H))
