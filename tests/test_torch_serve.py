"""The port's serve step against the reference's, on the CPU.

The reference's ``build_serve_step`` runs on ``make_host_mesh()`` (one
device: every collective is the identity), the port's
``repro_torch.distributed.lcrwmd_dist.build_serve_step`` on
``device="cpu"`` (each kernel's plain version).  Every step is built with
``bf16_matmul=False`` unless the test says otherwise.

Tolerances: 2.5e-2 absolute (the gram form's noise near zero) and 1e-4
relative on distances; indices exact wherever both neighbouring gaps
exceed it.  At tier 0 the candidates' cutoff decides which docs reach the
rerank, so the final ids are compared on the queries whose candidate sets
agree, and those must be most of them.  Reranks run at
``test_torch_segments.RERANK_KW``, where the two Sinkhorn backends agree
(that file says why).  The port's segmented step must equal its step over
a one-segment rebuild bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc_rwmd as jlc
from repro.data.docs import DocSet as JDocSet
from repro.distributed import lcrwmd_dist as jd
from repro.launch.mesh import make_host_mesh
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.data.docs import DocSet
from repro_torch.distributed import lcrwmd_dist as td
from test_torch_engine import _np, assert_topk_close
from test_torch_segments import RERANK_KW, _grow, _jslice
from test_torch_segments import corpus  # noqa: F401  (a fixture)

K = 6
B = 8
RERANK = dict(refine=True, rerank_wmd=True, rerank_budget=2 * K,
              wmd_kw=RERANK_KW)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


@pytest.fixture(scope="module")
def small(small_corpus):
    docs, emb = from_numpy(np.asarray(small_corpus.docs.ids),
                           np.asarray(small_corpus.docs.weights),
                           small_corpus.emb, device="cpu")
    return small_corpus, docs, emb


def _sets_agree(a, b):
    """Per query: do two candidate lists hold the same docs?"""
    return np.array([set(x) == set(y) for x, y in zip(_np(a), _np(b))])


def assert_tier0_close(got, want, got_cand, want_cand):
    agree = _sets_agree(got_cand.topk.indices, want_cand.topk.indices)
    assert agree.mean() >= 0.75, agree
    gd, wd = _np(got.topk.dists)[agree], _np(want.topk.dists)[agree]
    gi, wi = _np(got.topk.indices)[agree], _np(want.topk.indices)[agree]
    assert_topk_close(td.TopK(torch.tensor(gd), torch.tensor(gi)),
                      td.TopK(torch.tensor(wd), torch.tensor(wi)))
    if want.pruned_exact is not None:
        assert np.array_equal(_np(got.pruned_exact)[agree],
                              _np(want.pruned_exact)[agree])


# ---------------------------------------------------------------------------
# The engine-less materialized step and the all-pairs D1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("refine", [False, True])
def test_engineless_step_matches_reference(mesh, small, refine):
    c, docs, emb = small
    jemb = jnp.asarray(c.emb)
    want = jd.build_serve_step(mesh, k=7, refine=refine, bf16_matmul=False)(
        c.docs, c.docs[:5], jemb)
    got = td.build_serve_step(k=7, refine=refine, bf16_matmul=False,
                              device="cpu")(docs, docs[:5], emb)
    assert got.d_local.shape == (96, 5) and got.pruned_exact is None
    np.testing.assert_allclose(_np(got.d_local), _np(want.d_local),
                               rtol=1e-4, atol=2.5e-2)
    assert_topk_close(got.topk, want.topk)


def test_engineless_rerank_matches_reference(mesh, small):
    c, docs, emb = small
    kw = dict(k=4, refine=True, bf16_matmul=False, rerank_wmd=True,
              rerank_budget=10, wmd_kw=RERANK_KW)
    want = jd.build_serve_step(mesh, **kw)(c.docs, c.docs[8:14],
                                           jnp.asarray(c.emb))
    got = td.build_serve_step(device="cpu", **kw)(docs, docs[8:14], emb)
    assert got.topk.indices.shape == (6, 4)
    assert_topk_close(got.topk, want.topk)
    assert np.array_equal(_np(got.topk.indices[:, 0]), np.arange(8, 14))


def test_refine_only_tightens(small):
    """The symmetric refinement can only raise a candidate's bound."""
    _, docs, emb = small
    queries = docs[8:12]
    base = td.build_serve_step(k=6, bf16_matmul=False, device="cpu")(
        docs, queries, emb)
    ref = td.build_serve_step(k=6, refine=True, bf16_matmul=False,
                              device="cpu")(docs, queries, emb)
    for j in range(4):
        d1 = dict(zip(base.topk.indices[j].tolist(),
                      base.topk.dists[j].tolist()))
        for i, d in zip(ref.topk.indices[j].tolist(),
                        ref.topk.dists[j].tolist()):
            assert d >= d1[i]
        assert bool((ref.topk.dists[j][1:] >= ref.topk.dists[j][:-1]).all())


@pytest.mark.parametrize("bf16", [False, True])
def test_allpairs_d1_matches_reference(mesh, small, bf16):
    c, docs, emb = small
    want = jd.build_allpairs_d1(mesh, bf16_matmul=bf16)(c.docs, c.docs[:4],
                                                        jnp.asarray(c.emb))
    got = td.build_allpairs_d1(bf16_matmul=bf16, device="cpu")(docs, docs[:4],
                                                               emb)
    assert got.shape == (96, 4)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=2.5e-2)


# ---------------------------------------------------------------------------
# The monolithic-engine step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("self_exclude", [False, True])
def test_engine_step_streaming_equals_materialized(mesh, small, self_exclude):
    """Streaming and ``streaming=False`` agree (ids exact, values within
    1e-5), both match the reference, and self-exclusion drops each query's
    own row."""
    c, docs, emb = small
    ids = torch.arange(B, dtype=torch.int32)
    eng = tlc.LCRWMDEngine(docs, emb, device="cpu", row_block=32)
    jeng = jlc.LCRWMDEngine(c.docs, c.emb, row_block=32)
    kw = dict(k=5, bf16_matmul=False, self_exclude=self_exclude,
              row_block=32)
    args = dict(query_ids=ids) if self_exclude else {}
    mat = td.build_serve_step(engine=eng, streaming=False, **kw)(docs[:B],
                                                                 **args)
    stream = td.build_serve_step(engine=eng, streaming=True, **kw)(docs[:B],
                                                                   **args)
    assert stream.d_local is None and mat.d_local.shape == (96, B)
    assert torch.equal(stream.topk.indices, mat.topk.indices)
    torch.testing.assert_close(stream.topk.dists, mat.topk.dists, rtol=1e-5,
                               atol=1e-5)
    jargs = dict(query_ids=jnp.asarray(ids.numpy())) if self_exclude else {}
    want = jd.build_serve_step(mesh, engine=jeng, streaming=True, **kw)(
        c.docs[:B], **jargs)
    assert_topk_close(stream.topk, want.topk)
    first = stream.topk.indices[:, 0] == ids
    assert not first.any() if self_exclude else first.all()


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_engine_step_tiers_match_reference(mesh, small, tier):
    c, docs, emb = small
    eng = tlc.LCRWMDEngine(docs, emb, device="cpu")
    jeng = jlc.LCRWMDEngine(c.docs, c.emb)
    kw = dict(k=K, bf16_matmul=False, **RERANK)
    got = td.build_serve_step(engine=eng, **kw)(docs[:B], tier=tier)
    want = jd.build_serve_step(mesh, engine=jeng, **kw)(c.docs[:B], tier=tier)
    assert got.tier == want.tier == tier
    assert got.topk.indices.shape == (B, K)
    if tier == 0:
        cand = dict(tier=1)
        kc = dict(kw, k=2 * K)
        assert_tier0_close(
            got, want, td.build_serve_step(engine=eng, **kc)(docs[:B], **cand),
            jd.build_serve_step(mesh, engine=jeng, **kc)(c.docs[:B], **cand))
    else:
        assert_topk_close(got.topk, want.topk)


# ---------------------------------------------------------------------------
# The segmented step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seg_pair(corpus):
    c, docs, emb = corpus
    seg, ref, mono = _grow(c, docs, emb)
    dead = [2, 130, 150]
    for e in (seg, ref, mono):
        e.delete(dead)
    return c, docs, seg, ref, mono


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_segmented_step_tiers_match_reference(mesh, seg_pair, tier):
    c, docs, seg, ref, mono = seg_pair
    kw = dict(k=K, bf16_matmul=False, **RERANK)
    queries, jq = docs[:B], _jslice(c, 0, B)
    got = td.build_serve_step(engine=seg, **kw)(queries, tier=tier)
    want = jd.build_serve_step(mesh, engine=ref, **kw)(jq, tier=tier)
    assert got.tier == tier and got.topk.indices.shape == (B, K)
    assert not np.isin([2, 130, 150], _np(got.topk.indices)).any()
    if tier == 0:
        kc = dict(kw, k=2 * K)
        assert_tier0_close(
            got, want, td.build_serve_step(engine=seg, **kc)(queries, tier=1),
            jd.build_serve_step(mesh, engine=ref, **kc)(jq, tier=1))
        assert got.pruned_exact.dtype == torch.bool
    else:
        assert_topk_close(got.topk, want.topk)
    # the one-segment rebuild gives the same answers bit for bit
    same = td.build_serve_step(engine=mono, **kw)(queries, tier=tier)
    assert torch.equal(got.topk.dists, same.topk.dists)
    assert torch.equal(got.topk.indices, same.topk.indices)


def test_segmented_tier1_is_the_engines_topk(seg_pair):
    _, docs, seg, _, _ = seg_pair
    step = td.build_serve_step(engine=seg, k=K, bf16_matmul=False, **RERANK)
    got = step(docs[:B], tier=1)
    want = seg.topk_streaming(docs[:B], 2 * K)
    assert torch.equal(got.topk.indices, want.indices[:, :K])
    assert torch.equal(got.topk.dists, want.dists[:, :K])


def test_segmented_self_exclude_matches_reference(mesh, seg_pair):
    c, docs, seg, ref, _ = seg_pair
    kw = dict(k=K, bf16_matmul=False, self_exclude=True)
    ids = np.array([0, 1, 140, 141, 3, 4, 2, 150])  # deltas and dead docs
    queries = DocSet(docs.ids[ids], docs.weights[ids])
    jq = JDocSet(c.docs.ids[ids], c.docs.weights[ids])
    got = td.build_serve_step(engine=seg, **kw)(
        queries, query_ids=torch.tensor(ids))
    want = jd.build_serve_step(mesh, engine=ref, **kw)(
        jq, query_ids=jnp.asarray(ids))
    for j, g in enumerate(ids):
        assert g not in got.topk.indices[j]
    assert_topk_close(got.topk, want.topk)
    with pytest.raises(ValueError, match="query_ids"):
        td.build_serve_step(engine=seg, **kw)(queries)


def test_segmented_step_follows_the_corpus_without_rebuild(corpus):
    """Delete, append and compact between calls of ONE callable: the step
    re-reads the engine's state when its version changes (the tier-2
    centroids too), and the device masks are copied once per version."""
    c, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:96], emb, device="cpu")
    step = td.build_serve_step(engine=eng, k=K, bf16_matmul=False,
                               refine=True)
    queries = docs[11:19]
    before = step(queries)
    assert 11 in before.topk.indices[0]
    live = eng.segment_live_device()
    step(queries)
    assert eng.segment_live_device() is live
    eng.delete([11])
    for tier in (0, 1, 2):
        assert 11 not in step(queries, tier=tier).topk.indices
    assert eng.segment_live_device() is not live
    gids = eng.append(docs[11:12])                 # re-ingest doc 11
    for tier in (0, 1, 2):
        tk = step(queries, tier=tier).topk
        assert tk.indices[0, 0] == int(gids[0])
        assert int(tk.indices.max()) < eng.n_docs
    eng.compact()
    assert step(queries).topk.indices[0, 0] == int(gids[0])


def test_serve_step_refusals(small, corpus):
    _, docs, emb = small
    seg = tlc.SegmentedEngine(docs, emb, device="cpu")
    with pytest.raises(ValueError, match="streaming-only"):
        td.build_serve_step(engine=seg, k=3, streaming=False)
    with pytest.raises(ValueError, match="engine-backed"):
        td.build_serve_step(k=3, self_exclude=True, device="cpu")
    with pytest.raises(ValueError, match="engine-backed"):
        td.build_serve_step(k=3, streaming=True, device="cpu")
    with pytest.raises(ValueError, match="engine's"):
        td.build_serve_step(engine=seg, k=3, device="meta")
    # the candidate budget never exceeds the corpus
    step = td.build_serve_step(engine=seg, k=3, rerank_wmd=True,
                               rerank_budget=500, bf16_matmul=False,
                               wmd_kw=dict(max_iters=5))
    res = step(docs[:2])
    assert res.topk.indices.shape == (2, 3) and bool(res.pruned_exact.all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.build_serve_step(k=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.build_allpairs_d1()
