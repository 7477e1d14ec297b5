"""The slice as a whole: the port's engine and cascade against the reference.

The port runs on ``device="cpu"`` (each kernel's plain version); the
reference runs ``LCRWMDEngine(use_kernel=True, interpret=True)``, its Pallas
kernels in interpret mode.  Both see the same corpus (``conftest.small_corpus``
carried across by ``repro_torch.convert.from_numpy``).

Tolerances: distances that pass through phase 1 carry the gram form's
cancellation noise near zero, ``sqrt(eps_f32·|e|²)`` (the reference's own
kernel tests state the same 2.5e-2 floor); indices must be exact wherever
the neighbouring gap exceeds that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc_rwmd as jlc
from repro.core import pipeline as jpipe
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.core import pipeline as tpipe
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-4, 2.5e-2
KW = dict(eps=0.05, eps_scaling=2, max_iters=100)
B = 8


@pytest.fixture(scope="module")
def pair(small_corpus):
    ref = jlc.LCRWMDEngine(small_corpus.docs, small_corpus.emb,
                           use_kernel=True, interpret=True)
    docs, emb = from_numpy(np.asarray(small_corpus.docs.ids),
                           np.asarray(small_corpus.docs.weights),
                           small_corpus.emb, device="cpu")
    port = tlc.LCRWMDEngine(docs, emb, device="cpu")
    return ref, port, small_corpus.docs[:B], docs[:B], docs, emb


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_topk_close(got, want, tol=ATOL):
    """Values within tol; ids equal wherever both neighbour gaps exceed tol."""
    gd, gi = _np(got.dists), _np(got.indices)
    wd, wi = _np(want.dists), _np(want.indices)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=tol)
    gap_prev = np.full(wd.shape, np.inf)
    gap_prev[:, 1:] = np.diff(wd, axis=1)
    gap_next = np.full(wd.shape, np.inf)
    gap_next[:, :-1] = np.diff(wd, axis=1)
    clear = (gap_prev > tol) & (gap_next > tol)
    assert np.array_equal(gi[clear], wi[clear])
    return clear.mean()


def test_restrict_vocab_matches_reference(pair, small_corpus):
    ref, port, *_ = pair
    assert np.array_equal(_np(port.resident_restricted.ids),
                          _np(ref.resident_restricted.ids))
    assert np.array_equal(_np(port.emb_restricted), _np(ref.emb_restricted))
    assert np.array_equal(_np(port.old_to_new), _np(ref.old_to_new))
    # the candidates' targets, gathered by id, are the reference's _t_r rows
    n, h1 = port.resident.ids.shape
    t1, w1, _ = port.candidate_pairs(torch.arange(n), port.resident.ids[:1])
    assert np.array_equal(_np(t1), _np(ref._t_r).reshape(n, h1, -1))
    assert np.array_equal(_np(w1), _np(ref.resident.weights))


@pytest.mark.parametrize("method", ["one_sided", "symmetric"])
def test_dense_methods_match_reference(pair, method):
    ref, port, jq, tq, *_ = pair
    want = _np(getattr(ref, method)(jq))
    got = _np(getattr(port, method)(tq))
    assert got.shape == want.shape == (96, B)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method,k", [
    ("topk_streaming", 10), ("topk_streaming", 96),
    ("symmetric_topk_streaming", 10), ("topk", 7),
])
def test_streaming_topk_matches_reference(pair, method, k):
    ref, port, jq, tq, *_ = pair
    got = getattr(port, method)(tq, k)
    want = getattr(ref, method)(jq, k)
    assert got.indices.dtype == torch.int32
    assert assert_topk_close(got, want) > 0.5


def test_symmetric_streaming_independent_of_row_block(pair):
    _, port, _, tq, docs, emb = pair
    other = tlc.LCRWMDEngine(docs, emb, device="cpu", row_block=13)
    a = port.symmetric_topk_streaming(tq, 12)
    b = other.symmetric_topk_streaming(tq, 12)
    assert torch.equal(a.indices, b.indices)
    torch.testing.assert_close(a.dists, b.dists, rtol=1e-6, atol=1e-6)


def test_streaming_equals_dense_topk(pair):
    """Streaming top-k == top-k of the materialized matrix, ties included."""
    from repro_torch.core.topk import topk_smallest_cols

    _, port, _, tq, *_ = pair
    dense = topk_smallest_cols(port.one_sided(tq), 15)
    stream = port.topk_streaming(tq, 15)
    assert torch.equal(stream.indices, dense.indices)
    assert torch.equal(stream.dists, dense.dists)


def test_rerank_topk_matches_reference(pair):
    ref, port, jq, tq, *_ = pair
    cand = ref.topk_streaming(jq, 12)
    want = ref.rerank_topk(jq, cand.indices, 5, sinkhorn_kw=KW)
    got = port.rerank_topk(tq, torch.tensor(np.asarray(cand.indices)), 5,
                           sinkhorn_kw=KW)
    assert_topk_close(got, want)
    assert np.array_equal(_np(got.indices[:, 0]), np.arange(B))  # self first


def test_rerank_rejects_unknown_solver_keys(pair):
    _, port, _, tq, *_ = pair
    cand = port.topk_streaming(tq, 4)
    with pytest.raises(TypeError, match="unknown sinkhorn"):
        port.rerank_topk(tq, cand.indices, 2, sinkhorn_kw=dict(epsilon=0.1))
    # the reference's jnp-only knob is dropped, not rejected
    port.rerank_topk(tq, cand.indices, 2,
                     sinkhorn_kw=dict(max_iters=3, absorb_every=2))


@pytest.mark.parametrize("with_engine", [True, False])
def test_pruned_wmd_topk_matches_reference(pair, small_corpus, with_engine):
    ref, port, jq, tq, docs, emb = pair
    want = jpipe.pruned_wmd_topk(
        small_corpus.docs, jq, jnp.asarray(small_corpus.emb), k=5,
        sinkhorn_kw=KW, engine=ref if with_engine else None, use_kernel=True,
        interpret=True)
    got = tpipe.pruned_wmd_topk(docs, tq, emb, k=5, sinkhorn_kw=KW,
                                engine=port if with_engine else None,
                                use_kernel=True)
    assert_topk_close(got.topk, want.topk)
    assert_topk_close(got.rwmd_topk, want.rwmd_topk)
    np.testing.assert_allclose(_np(got.cutoff), _np(want.cutoff), rtol=RTOL,
                               atol=ATOL)
    assert np.array_equal(_np(got.n_refined), _np(want.n_refined))
    assert np.array_equal(_np(got.pruned_exact), _np(want.pruned_exact))
    assert got.n_refined.dtype == torch.int32


def test_pruned_full_budget_is_certified(pair):
    _, port, _, tq, docs, emb = pair
    res = tpipe.pruned_wmd_topk(docs, tq, emb, k=3, refine_budget=10_000,
                                sinkhorn_kw=dict(max_iters=5), engine=port)
    assert bool(res.pruned_exact.all())


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_cascade_tiers_match_reference(pair, tier):
    ref, port, jq, tq, *_ = pair
    want = jpipe.cascade_topk(ref, jq, 5, tier=tier, sinkhorn_kw=KW)
    got = tpipe.cascade_topk(port, tq, 5, tier=tier, sinkhorn_kw=KW)
    # Tier 2's centroid distances are gram-form too: the same noise floor.
    assert_topk_close(got, want)


def test_fused_topk_on_engine_tensors_matches_streaming(pair):
    _, port, _, tq, *_ = pair
    q_ids = port.old_to_new[tq.ids.long()].clamp(min=0)
    # every query word of a resident doc lies inside v_e
    assert bool((port.old_to_new[tq.ids.long()][tq.weights > 0] >= 0).all())
    d, i = tops.lc_rwmd_fused_topk(
        port.emb_restricted, q_ids, tq.weights, port.resident_restricted.ids,
        port.resident_restricted.weights, k=9, fuse="kernel")
    want = port.topk_streaming(tq, 9)
    assert torch.equal(i, want.indices)
    torch.testing.assert_close(d, want.dists, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def wide_pair():
    """300 resident docs: room for k and rerank budgets above 128 (the
    card's fused top-k keeps k <= 128 in shared memory, more in global)."""
    from repro.data.synth import CorpusSpec, make_corpus

    c = make_corpus(CorpusSpec(n_docs=300, vocab_size=512, emb_dim=32,
                               h_max=16, mean_h=8.0, n_classes=4, seed=16))
    ref = jlc.LCRWMDEngine(c.docs, c.emb)
    docs, emb = from_numpy(np.asarray(c.docs.ids), np.asarray(c.docs.weights),
                           c.emb, device="cpu")
    port = tlc.LCRWMDEngine(docs, emb, device="cpu", row_block=64)
    return ref, port, c.docs[:4], docs[:4]


@pytest.mark.parametrize("method", ["topk_streaming", "symmetric_topk_streaming"])
def test_streaming_topk_above_128_matches_reference(wide_pair, method):
    ref, port, jq, tq = wide_pair
    got = getattr(port, method)(tq, 150)
    want = getattr(ref, method)(jq, 150)
    assert got.dists.shape == (4, 150)
    # 150 of 300 docs: the values crowd, so fewer gaps clear the tolerance
    assert assert_topk_close(got, want) > 0.25


def test_cascade_rerank_budget_above_128_matches_reference(wide_pair):
    ref, port, jq, tq = wide_pair
    want = jpipe.cascade_topk(ref, jq, 5, rerank_budget=150, sinkhorn_kw=KW)
    got = tpipe.cascade_topk(port, tq, 5, rerank_budget=150, sinkhorn_kw=KW)
    assert_topk_close(got, want)
    assert torch.equal(got.indices[:, 0], torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_knn_classify_matches_reference(pair, small_corpus, weights):
    ref, port, jq, tq, *_ = pair
    want_topk = ref.topk_streaming(jq, 7)
    want = jpipe.knn_classify(want_topk, jnp.asarray(small_corpus.labels), 4,
                              weights=weights)
    got = tpipe.knn_classify(
        tpipe.topk_lib.TopK(torch.tensor(np.asarray(want_topk.dists)),
                            torch.tensor(np.asarray(want_topk.indices))),
        small_corpus.labels, 4, weights=weights)
    assert np.array_equal(_np(got), _np(want))
    with pytest.raises(ValueError):
        tpipe.knn_classify(port.topk_streaming(tq, 3), small_corpus.labels, 4,
                           weights="bogus")


@pytest.mark.parametrize("kwargs,flags", [
    (dict(k=5, n_resident=200), [[True, False, False]] * 3 + [[True] * 3]),
    (dict(k=4, n_resident=100, decay_after=2),
     [[False], [True], [True], [True], [True], [False], [True]] + [[True]] * 6),
    (dict(k=2, n_resident=50, init=40, growth=3.0, decay_after=1, decay=0.25),
     [[True], [True], [False, True], [True], [True]]),
])
def test_adaptive_refine_budget_matches_reference(kwargs, flags):
    want = jpipe.AdaptiveRefineBudget(**kwargs)
    got = tpipe.AdaptiveRefineBudget(**kwargs)
    for f in flags:
        assert got.update(torch.tensor(f)) == want.update(np.array(f))
        assert (got.exact_streak, got.failed_budget) == (
            want.exact_streak, want.failed_budget)
    got.on_corpus_change(30)
    want.on_corpus_change(30)
    assert (got.budget, got.saturated) == (want.budget, want.saturated)
    with pytest.raises(ValueError):
        tpipe.AdaptiveRefineBudget(k=1, n_resident=10, growth=1.0)


def test_engine_without_device_raises_without_cuda(pair, monkeypatch):
    """No silent CPU fallback: device=None means the card."""
    *_, docs, emb = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlc.LCRWMDEngine(docs, emb)
