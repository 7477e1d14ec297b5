"""The port's ``CorpusManager`` on the CPU: the LRU device-byte cache,
eviction and readmission, the dedup ingest gate, and an indexed corpus
through ingest, delete and compact.

Everything runs on ``device="cpu"`` (each kernel's plain version) over
``tests/test_corpus_manager.py``'s corpus spec (256 docs, h_max 16).
Within the port, answers before an eviction and after the readmission
must be equal bit for bit (the readmitted engine holds the same docs in
one segment, and a segment's result does not depend on how the corpus is
split).  The dedup gate must refuse exactly what the reference's refuses.
An indexed corpus with exhaustive routing (every cell probed, no bound)
must answer as the flat corpus does, bit for bit, after each lifecycle
step.
"""

import numpy as np
import pytest
import torch

from repro.data.docs import DocSet as JDocSet
from repro.data.synth import CorpusSpec, make_corpus
from repro.serving import CorpusManager as JCorpusManager
from repro_torch.convert import from_numpy
from repro_torch.core.pipeline import AdaptiveRefineBudget
from repro_torch.data.docs import DocSet
from repro_torch.index import IndexConfig
from repro_torch.obs import CorpusEvicted, CorpusReadmitted, Observability
from repro_torch.serving import (
    CorpusManager,
    IndexedCorpusState,
    QueryServer,
    ServerConfig,
)

K = 4


@pytest.fixture(scope="module")
def corpus():
    c = make_corpus(CorpusSpec(n_docs=256, vocab_size=512, emb_dim=48,
                               h_max=16, mean_h=8.0, n_classes=4, seed=9))
    docs, emb = from_numpy(np.asarray(c.docs.ids), np.asarray(c.docs.weights),
                           c.emb, device="cpu")
    return c, docs, emb


def _cat(*parts):
    return DocSet(ids=torch.cat([p.ids for p in parts]),
                  weights=torch.cat([p.weights for p in parts]))


def _tenants(docs, n=3, size=64):
    return {f"t{t}": docs[t * size:(t + 1) * size] for t in range(n)}


def _same(a, b):
    return torch.equal(a.indices, b.indices) and torch.equal(a.dists, b.dists)


def test_lru_eviction_and_readmission_bit_equal(corpus):
    """On the CPU the engines take ``row_block=1`` and ``vocab_chunk=1``, so
    every plain GEMM of the fold has the same shape however the corpus is
    split.  At the defaults the two segments' GEMMs (their own restricted
    vocabularies, slabs of 64 and 16 rows) and the readmitted segment's
    (80 rows) differ in shape, and BLAS may round such GEMMs apart in the
    last bit; the gram form's square root near 0 turns one ulp of the
    product into up to 7.0e-3 of a top-4 distance on this corpus
    (``tools/gram_ulp_probe.py``).  The card's kernels fix their sum
    orders per row, and ``tests/test_torch_cuda.py`` holds the card to bit
    equality at the defaults."""
    _, docs, emb = corpus
    obs = Observability()
    mgr = CorpusManager(emb, device="cpu", obs=obs,
                        engine_kw={"row_block": 1, "vocab_chunk": 1})
    for cid, d in _tenants(docs).items():
        mgr.add_corpus(cid, d)
    st0 = mgr.checkout("t0")
    mgr.ingest("t0", docs[200:216])          # a delta segment
    st0.engine.delete([3, 70])               # tombstones survive the trip
    queries = docs[:8]
    before = st0.engine.topk(queries, K)
    before_one = st0.engine.topk_streaming(queries, K)
    assert mgr.resident_bytes == sum(
        mgr.checkout(c).engine.nbytes for c in ("t1", "t2", "t0"))

    mgr.cache_bytes = mgr.resident_bytes - 1     # room for all but one
    mgr.checkout("t1"), mgr.checkout("t2")       # t0 becomes LRU
    mgr._enforce_budget(keep="t2")
    assert not mgr.is_resident("t0") and mgr.stats["evictions"] == 1
    assert mgr.has_corpus("t0") and "t0" in mgr.snapshot()["evicted"]
    assert mgr.resident_bytes <= mgr.cache_bytes

    st0b = mgr.checkout("t0")                    # readmission
    assert mgr.stats["readmissions"] == 1 and mgr.is_resident("t0")
    assert mgr.resident_bytes <= mgr.cache_bytes
    assert st0b.engine.n_segments == 1 and st0b.engine.n_docs == 80
    assert st0b.engine.n_live == 78 and not st0b.engine.live_mask()[70]
    assert _same(before, st0b.engine.topk(queries, K))
    assert _same(before_one, st0b.engine.topk_streaming(queries, K))
    kinds = [type(e) for e in obs.events]
    assert kinds.count(CorpusEvicted) == mgr.stats["evictions"]
    assert kinds.count(CorpusReadmitted) == 1
    names = set(obs.metrics.snapshot())
    assert {"corpus_evictions_total", "corpus_readmissions_total",
            "corpus_resident_bytes"} <= names


def test_has_corpus_holds_through_eviction_and_readmission(corpus):
    """The lock-free ``has_corpus`` (the submit path's check) finds a
    corpus at every point of its eviction and of its readmission, so a
    submit that races them is never refused as an unknown corpus."""
    _, docs, emb = corpus
    mgr = CorpusManager(emb, device="cpu")
    mgr.add_corpus("a", docs[:64])
    mgr.add_corpus("b", docs[64:128])
    seen = []
    eng = mgr.checkout("a").engine
    live_mask = eng.live_mask
    eng.live_mask = lambda: (seen.append(mgr.has_corpus("a")), live_mask())[1]
    mgr.evict("a")                                # spills mid-eviction
    readmit = mgr._readmit

    def spy(cid, snap):
        seen.append(mgr.has_corpus(cid))
        return readmit(cid, snap)

    mgr._readmit = spy
    mgr.checkout("a")
    assert seen == [True, True]
    assert mgr.is_resident("a") and "a" not in mgr.snapshot()["evicted"]
    assert mgr.corpus_ids == ["b", "a"]


def test_dedup_gate_refuses_what_the_reference_refuses(corpus):
    """Exact copies of live docs and a copy inside the batch are refused;
    a copy of a tombstoned doc is admitted — mask for mask the reference's."""
    c, docs, emb = corpus
    mine = CorpusManager(emb, device="cpu", dedup_threshold=0.05)
    theirs = JCorpusManager(c.emb, dedup_threshold=0.05)
    mine.add_corpus("a", docs[:64])
    theirs.add_corpus("a", JDocSet(ids=c.docs.ids[:64],
                                   weights=c.docs.weights[:64]))
    sel = [100, 7, 101, 30, 100, 102]           # 7, 30 live; 100 twice
    batch = DocSet(ids=docs.ids[sel], weights=docs.weights[sel])
    jbatch = JDocSet(ids=c.docs.ids[np.array(sel)],
                     weights=c.docs.weights[np.array(sel)])
    gids, keep = mine.ingest("a", batch)
    jgids, jkeep = theirs.ingest("a", jbatch)
    np.testing.assert_array_equal(keep, [True, False, True, False, False,
                                         True])
    np.testing.assert_array_equal(keep, jkeep)
    np.testing.assert_array_equal(gids, jgids)
    assert mine.stats["deduped_docs"] == theirs.stats["deduped_docs"] == 3
    for m in (mine, theirs):
        m.delete_docs("a", [7])
    _, keep2 = mine.ingest("a", docs[7:8])
    _, jkeep2 = theirs.ingest("a", JDocSet(ids=c.docs.ids[7:8],
                                           weights=c.docs.weights[7:8]))
    np.testing.assert_array_equal(keep2, [True])
    np.testing.assert_array_equal(jkeep2, [True])


def test_per_corpus_budgets_follow_the_lifecycle(corpus):
    """Each tenant owns its budget; ingest/delete re-anchor only its own,
    and readmission resets its decay floor."""
    _, docs, emb = corpus
    made = []

    def make_budget(engine):
        b = AdaptiveRefineBudget(k=K, n_resident=engine.n_live, init=8,
                                 decay_after=2)
        made.append(b)
        return b

    mgr = CorpusManager(emb, device="cpu", make_budget=make_budget)
    mgr.add_corpus("a", docs[:64])
    mgr.add_corpus("b", docs[64:128])
    a, b = mgr.checkout("a").budget, mgr.checkout("b").budget
    assert a is not b and made == [a, b]
    a.update(np.zeros(8, bool))                  # a fails: grows, floor 8
    assert (a.budget, a.failed_budget) == (16, 8) and b.budget == 8
    mgr.ingest("a", docs[200:210])
    assert a.n_resident == 74 and a.failed_budget == 0 and b.n_resident == 64
    a.update(np.zeros(8, bool))
    mgr.delete_docs("a", [0, 1])
    assert a.n_resident == 72 and a.failed_budget == 0
    a.update(np.zeros(8, bool))
    mgr.evict("a")
    st = mgr.checkout("a")
    assert st.budget is a and a.failed_budget == 0 and a.budget == 64


def test_indexed_corpus_follows_ingest_delete_compact(corpus):
    """A server over an indexed corpus (exhaustive routing: every cell,
    no bound) answers as the flat server does, bit for bit, after ingest
    (``index.add``), a delete and a compaction (``index.rebuild``)."""
    _, docs, emb = corpus
    base = dict(k=K, max_batch=8, h_max=16, device="cpu",
                refine_symmetric=True)
    flat = QueryServer(docs[:160], emb, ServerConfig(**base))
    routed = QueryServer(docs[:160], emb, ServerConfig(
        index=IndexConfig(num_cells=6, top_p=6, probe_cap=6), **base))
    st = routed._core.manager.checkout("default")
    assert isinstance(st, IndexedCorpusState)
    assert st.nbytes == st.engine.nbytes + st.index.nbytes
    idx = st.index
    picks = [2, 40, 77, 150, 5, 120]
    ids, w = docs.ids.numpy(), docs.weights.numpy()

    def answers(server):
        for j in picks:
            server.submit(ids[j], w[j])
        return server.flush()

    def check(step):
        got, want = answers(routed), answers(flat)
        for g, x in zip(got, want):
            assert g[0].tobytes() == x[0].tobytes(), step
            assert g[1].tobytes() == x[1].tobytes(), step
        return got

    check("built")
    new = _cat(docs[200:230], docs[5:6])         # the last: a copy of doc 5
    for s in (flat, routed):
        gids, keep = s.ingest(new)
        assert keep.all() and list(gids) == list(range(160, 191))
    assert idx.labels.shape == (191,)
    got = check("ingest")
    assert 190 in got[picks.index(5)][0][:2]     # the copy next to doc 5
    for s in (flat, routed):
        assert s.delete_docs([40, 190]) == 2
    got = check("delete")
    assert all(40 not in a[0] and 190 not in a[0] for a in got)
    v = idx.version
    for s in (flat, routed):
        s.compact()
    assert idx.version > v and routed.engine.n_segments == 1
    check("compact")
