"""The paper's comparison path in the port against the reference.

Streaming LC-RWMD (every ``fuse`` backend and chunking), the quadratic RWMD
(the fused kernel's plain version and the GEMM-shaped ``core/rwmd.py``),
and the WMD baselines (log-domain and batched Sinkhorn, the LP oracle).
The same numpy inputs, made from a seed, go through both packages; the
reference's Pallas kernels run in interpret mode.

Tolerances: distances that pass through a gram-form distance carry its
cancellation noise near zero, so rtol 1e-4 and atol 1e-2 (the reference's
own bar in ``tests/test_kernels.py`` and ``tests/test_fused_engine.py``);
the WMD solvers agree to atol 1e-4 on the same cost matrices (as in
``tests/test_wmd_batched.py``), and on corpus docs to rtol 1e-4 with the
gram floor of ``tests/test_torch_engine.py`` (see ``GRAM_ATOL``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc_rwmd as jlc
from repro.core import pipeline as jpipe
from repro.core import rwmd as jrw
from repro.core import wmd as jwmd
from repro.data.docs import DocSet as JDocSet
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.core import pipeline as tpipe
from repro_torch.core import rwmd as trw
from repro_torch.core import wmd as twmd
from repro_torch.data.docs import DocSet as TDocSet
from repro_torch.data.synth import make_corpus, table_iv_spec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sinkhorn_wmd as tsk

RTOL, ATOL = 1e-4, 1e-2
WMD_ATOL = 1e-4
# WMD of corpus docs (costs up to ~35): rtol 1e-4, as the reference's corpus
# test in tests/test_wmd_batched.py.  Across the two packages the cost tiles
# of corpus docs differ where docs share words: those near-zero distances
# carry the gram form's cancellation noise, sqrt(eps_f32·|e|²), computed in
# another order in each package, so the absolute floor is the 2.5e-2 of
# tests/test_torch_engine.py.  Within the port the same tiles are shared.
WMD_RTOL = 1e-4
GRAM_ATOL = 2.5e-2
CONFIGS = [
    dict(eps=0.01, eps_scaling=4, max_iters=500, tol=1e-5),
    dict(eps=0.02, eps_scaling=3, max_iters=200),
    dict(eps=0.05, eps_scaling=2, max_iters=60),
]


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def corpus(small_corpus):
    """(reference DocSet, reference emb, port DocSet, port emb)."""
    docs, emb = from_numpy(np.asarray(small_corpus.docs.ids),
                           np.asarray(small_corpus.docs.weights),
                           small_corpus.emb, device="cpu")
    return small_corpus.docs, jnp.asarray(small_corpus.emb), docs, emb


def _hists(rng, n, h, v):
    ids = rng.integers(0, v, size=(n, h)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(n, h)).astype(np.float32)
    for j in range(n):  # random padding tail per doc (>= 1 valid word)
        w[j, rng.integers(1, h + 1):] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    return ids, w


# ---------------------------------------------------------------------------
# Streaming LC-RWMD (B5, and B1 -> B2 per chunk)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("vocab_chunk", [64, 100, 512, 4096])
@pytest.mark.parametrize("fuse", ["kernel", "scan", "jnp"])
def test_streaming_matches_reference(corpus, fuse, vocab_chunk):
    """Any backend and any chunking (divisible or not, larger than v or
    not) gives the reference's streaming value."""
    jdocs, jemb, docs, emb = corpus
    want = np.asarray(jlc.lc_rwmd_streaming(
        jdocs, jdocs[:5], jemb, vocab_chunk=vocab_chunk, fuse="jnp"))
    got = tlc.lc_rwmd_streaming(docs, docs[:5], emb, vocab_chunk=vocab_chunk,
                                fuse=fuse)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fuse", ["kernel", "scan"])
def test_streaming_matches_reference_kernels(corpus, fuse):
    """Against the reference's own fused and scanned Pallas kernels."""
    jdocs, jemb, docs, emb = corpus
    want = np.asarray(jlc.lc_rwmd_streaming(
        jdocs, jdocs[:4], jemb, vocab_chunk=128, fuse=fuse, block_v=64,
        interpret=True))
    got = tlc.lc_rwmd_streaming(docs, docs[:4], emb, vocab_chunk=128,
                                fuse=fuse)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    one = tlc.lc_rwmd_one_sided(docs, docs[:4], emb)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=RTOL, atol=ATOL)


def test_streaming_bf16_matches_reference(corpus):
    jdocs, jemb, docs, emb = corpus
    want = np.asarray(jlc.lc_rwmd_streaming(
        jdocs, jdocs[:3], jemb, vocab_chunk=100, fuse="jnp", bf16_matmul=True))
    got = tlc.lc_rwmd_streaming(docs, docs[:3], emb, vocab_chunk=100,
                                fuse="kernel", bf16_matmul=True)
    # bf16 operands: the reference's bf16 bar for phase 1 (rtol 5e-2)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=0.7)


def test_streaming_rejects_unknown_fuse(corpus):
    *_, docs, emb = corpus
    with pytest.raises(ValueError, match="fuse"):
        tlc.lc_rwmd_streaming(docs, docs[:2], emb, fuse="bogus")


# ---------------------------------------------------------------------------
# Quadratic RWMD: the fused kernel (B7) and core/rwmd.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,h1,h2,m,b", [
    (16, 8, 8, 48, 2),
    (8, 16, 4, 300, 3),
    (24, 4, 12, 64, 1),
    (6, 160, 24, 32, 2),  # Table IV set 1's h_max: more than 128 doc words
])
def test_rwmd_pairwise_matches_reference_kernel(n, h1, h2, m, b):
    rng = np.random.default_rng(n * 100 + h1 * 10 + h2 + m + b)
    v = 256
    emb = rng.normal(size=(v, m)).astype(np.float32)
    r_ids, r_w = _hists(rng, n, h1, v)
    q_ids, q_w = _hists(rng, b, h2, v)
    want = np.asarray(jops.rwmd_pairwise(
        jnp.asarray(emb), jnp.asarray(r_ids), jnp.asarray(r_w),
        jnp.asarray(q_ids), jnp.asarray(q_w), interpret=True))
    got = tops.rwmd_pairwise(_t(emb), _t(r_ids), _t(r_w), _t(q_ids), _t(q_w))
    assert got.shape == (n, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    t1 = emb[r_ids.reshape(-1)].reshape(n, h1, m)
    for j in range(b):
        oracle = np.asarray(jref.rwmd_pairwise_ref(
            jnp.asarray(t1), jnp.asarray(r_w), jnp.asarray(emb[q_ids[j]]),
            jnp.asarray(q_w[j])))
        mine = tref.rwmd_pairwise_ref(_t(t1), _t(r_w), _t(emb[q_ids[j]]),
                                      _t(q_w[j])).numpy()
        np.testing.assert_allclose(mine, oracle, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[:, j].numpy(), oracle, rtol=RTOL,
                                   atol=ATOL)


def test_rwmd_pairwise_bf16_matches_reference_kernel():
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(128, 64)).astype(np.float32)
    r_ids, r_w = _hists(rng, 12, 8, 128)
    q_ids, q_w = _hists(rng, 3, 8, 128)
    want = np.asarray(jops.rwmd_pairwise(
        jnp.asarray(emb), jnp.asarray(r_ids), jnp.asarray(r_w),
        jnp.asarray(q_ids), jnp.asarray(q_w), bf16_matmul=True,
        interpret=True))
    got = tops.rwmd_pairwise(_t(emb), _t(r_ids), _t(r_w), _t(q_ids), _t(q_w),
                             bf16_matmul=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_rwmd_core_matches_reference(corpus):
    jdocs, jemb, docs, emb = corpus
    jq, tq = jdocs[:6], docs[:6]
    want = np.asarray(jrw.rwmd_many_vs_many(jdocs, jq, jemb))
    for chunk in (None, 2, 3):
        got = trw.rwmd_many_vs_many(docs, tq, emb, query_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    want1 = np.asarray(jrw.rwmd_one_vs_many(jdocs, jq.ids[2], jq.weights[2],
                                            jemb))
    got1 = trw.rwmd_one_vs_many(docs, tq.ids[2], tq.weights[2], emb)
    np.testing.assert_allclose(got1.numpy(), want1, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got1.numpy(), want[:, 2], rtol=RTOL, atol=ATOL)
    for i, j in ((0, 1), (5, 40), (17, 17)):
        wp = float(jrw.rwmd_pair(jdocs.ids[i], jdocs.weights[i],
                                 jdocs.ids[j], jdocs.weights[j], jemb))
        gp = float(trw.rwmd_pair(docs.ids[i], docs.weights[i], docs.ids[j],
                                 docs.weights[j], emb))
        assert abs(gp - wp) <= ATOL + RTOL * abs(wp)
    idx1, idx2 = np.arange(10), np.arange(10, 20)
    want_p = np.asarray(jrw.rwmd_pairs_from_t(
        jemb[jdocs.ids[idx1]], jdocs.weights[idx1], jemb[jdocs.ids[idx2]],
        jdocs.weights[idx2]))
    got_p = trw.rwmd_pairs_from_t(emb[docs.ids[idx1].long()],
                                  docs.weights[idx1],
                                  emb[docs.ids[idx2].long()],
                                  docs.weights[idx2])
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=RTOL, atol=ATOL)
    # the fused kernel's plain version computes the same quadratic RWMD
    fused = tops.rwmd_pairwise(emb, docs.ids, docs.weights, tq.ids,
                               tq.weights)
    np.testing.assert_allclose(fused.numpy(), want, rtol=RTOL, atol=ATOL)


def test_rwmd_many_vs_many_query_chunk_must_divide(corpus):
    *_, docs, emb = corpus
    with pytest.raises(ValueError, match="divisible"):
        trw.rwmd_many_vs_many(docs, docs[:5], emb, query_chunk=2)


def test_empty_histograms_in_both_rwmd_paths():
    """An empty resident doc and an empty query.  The two reference paths
    disagree and the port matches each: the fused kernel counts a minimum
    over nothing as 3.4e38 (3.4e38 on the empty side, 0 where both are
    empty), while core/rwmd.py masks with inf, so an empty query gives inf
    and an empty resident doc gives inf·0 = NaN in its column pass."""
    rng = np.random.default_rng(11)
    v, m = 64, 16
    emb = rng.normal(size=(v, m)).astype(np.float32)
    r_ids, r_w = _hists(rng, 6, 5, v)
    q_ids, q_w = _hists(rng, 3, 4, v)
    r_w[2] = 0.0
    q_w[1] = 0.0
    want_k = np.asarray(jops.rwmd_pairwise(
        jnp.asarray(emb), jnp.asarray(r_ids), jnp.asarray(r_w),
        jnp.asarray(q_ids), jnp.asarray(q_w), interpret=True))
    got_k = tops.rwmd_pairwise(_t(emb), _t(r_ids), _t(r_w), _t(q_ids),
                               _t(q_w)).numpy()
    assert np.all(np.isfinite(got_k))
    np.testing.assert_allclose(got_k, want_k, rtol=RTOL, atol=ATOL)
    assert got_k[2, 1] == 0.0 and want_k[2, 1] == 0.0
    assert got_k[2, 0] > 3e38 and got_k[0, 1] > 3e38
    jr = JDocSet(ids=jnp.asarray(r_ids), weights=jnp.asarray(r_w))
    jq = JDocSet(ids=jnp.asarray(q_ids), weights=jnp.asarray(q_w))
    tr = TDocSet(ids=_t(r_ids), weights=_t(r_w))
    tq = TDocSet(ids=_t(q_ids), weights=_t(q_w))
    want_c = np.asarray(jrw.rwmd_many_vs_many(jr, jq, jnp.asarray(emb)))
    got_c = trw.rwmd_many_vs_many(tr, tq, _t(emb)).numpy()
    # equal_nan: the reference's own NaN for the empty resident doc
    np.testing.assert_allclose(got_c, want_c, rtol=RTOL, atol=ATOL,
                               equal_nan=True)
    assert np.all(np.isnan(got_c[2])) and np.all(np.isnan(want_c[2]))
    assert np.isinf(got_c[0, 1]) and np.isinf(want_c[0, 1])


# ---------------------------------------------------------------------------
# WMD baselines
# ---------------------------------------------------------------------------
def _wmd_problems(seed, p=10, h1=12, h2=10, m=16):
    rng = np.random.default_rng(seed)

    def hist(h):
        w = rng.random(h).astype(np.float32)
        w[rng.random(h) < 0.3] = 0
        if w.sum() == 0:
            w[0] = 1.0
        return w / w.sum()

    w1 = np.stack([hist(h1) for _ in range(p)])
    w2 = np.stack([hist(h2) for _ in range(p)])
    t1 = rng.normal(size=(p, h1, m)).astype(np.float32)
    t2 = rng.normal(size=(p, h2, m)).astype(np.float32)
    c = np.sqrt(np.maximum(
        (t1**2).sum(-1)[:, :, None] + (t2**2).sum(-1)[:, None, :]
        - 2 * np.einsum("phm,pqm->phq", t1, t2), 0)).astype(np.float32)
    return w1, w2, t1, t2, c


@pytest.mark.parametrize("kw", CONFIGS)
def test_sinkhorn_log_matches_reference(kw):
    w1, w2, _, _, c = _wmd_problems(1, p=3)
    for i in range(3):
        want = jwmd.sinkhorn_log(jnp.asarray(w1[i]), jnp.asarray(w2[i]),
                                 jnp.asarray(c[i]), **kw)
        got = twmd.sinkhorn_log(_t(w1[i]), _t(w2[i]), _t(c[i]), **kw)
        assert abs(float(got.cost) - float(want.cost)) <= WMD_ATOL
        assert got.cost.shape == () and got.n_iters.dtype == torch.int32


@pytest.mark.parametrize("absorb_every", [1, 4, 7])
@pytest.mark.parametrize("kw", CONFIGS)
def test_sinkhorn_log_batched_matches_reference(kw, absorb_every):
    w1, w2, _, _, c = _wmd_problems(2)
    want = jwmd.sinkhorn_log_batched(jnp.asarray(w1), jnp.asarray(w2),
                                     jnp.asarray(c), absorb_every=absorb_every,
                                     **kw)
    got = twmd.sinkhorn_log_batched(_t(w1), _t(w2), _t(c),
                                    absorb_every=absorb_every, **kw)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               atol=WMD_ATOL)
    # per-pair iteration counts: the same stopping rule; float32 rounding
    # moves the step where the error crosses tol by a few iterations
    want_it = np.asarray(want.n_iters)
    assert np.all(np.abs(got.n_iters.numpy() - want_it)
                  <= np.maximum(2, 0.01 * want_it))


def test_sinkhorn_batched_handles_empty_pairs():
    p, h = 4, 6
    a = np.zeros((p, h), np.float32)
    b = np.zeros((p, h), np.float32)
    a[0] = b[0] = 1.0 / h
    c = np.abs(np.random.default_rng(0).normal(size=(p, h, h))).astype(np.float32)
    got = twmd.sinkhorn_log_batched(_t(a), _t(b), _t(c), eps=0.05,
                                    eps_scaling=2, max_iters=50)
    assert torch.isfinite(got.cost).all()
    assert torch.all(got.cost[1:] == 0)
    want = jwmd.sinkhorn_log_batched(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(c), eps=0.05, eps_scaling=2,
                                     max_iters=50)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               atol=WMD_ATOL)


def test_wmd_pair_one_vs_many_and_batched_match_reference(corpus):
    jdocs, jemb, docs, emb = corpus
    kw = dict(eps=0.02, eps_scaling=3, max_iters=200)
    res = jdocs[:12]
    want = np.asarray(jwmd.wmd_one_vs_many(res, jdocs.ids[40],
                                           jdocs.weights[40], jemb, **kw))
    got = twmd.wmd_one_vs_many(docs[:12], docs.ids[40], docs.weights[40], emb,
                               **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=WMD_RTOL, atol=GRAM_ATOL)
    for i in (0, 7):
        wp = float(jwmd.wmd_pair(jdocs.ids[i], jdocs.weights[i],
                                 jdocs.ids[40], jdocs.weights[40], jemb, **kw))
        gp = float(twmd.wmd_pair(docs.ids[i], docs.weights[i], docs.ids[40],
                                 docs.weights[40], emb, **kw))
        assert abs(gp - wp) <= GRAM_ATOL + WMD_RTOL * abs(wp)
        assert abs(gp - float(got[i])) <= WMD_ATOL + WMD_RTOL * abs(gp)
    i, j = np.arange(8), np.arange(30, 38)
    want_b = np.asarray(jwmd.wmd_batched(jdocs.ids[i], jdocs.weights[i],
                                         jdocs.ids[j], jdocs.weights[j], jemb,
                                         **kw))
    got_b = twmd.wmd_batched(docs.ids[i], docs.weights[i], docs.ids[j],
                             docs.weights[j], emb, **kw)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=WMD_RTOL,
                               atol=GRAM_ATOL)


def test_unconverged_rerank_gap_is_the_references():
    """At the quickstart rerank's settings (eps 0.05 against costs of ~30,
    100 iterations a level) most cascade pairs stop at max_iters, and the
    log-domain kernel and the batched exp-domain solver part ways.  The
    reference's two backends part ways by as much as the port's: each port
    backend matches its reference, so the gap is the reference's semantics.
    Table IV set 2 statistics (h 48, m 300), cut to 28,000 docs; the 64
    pairs are two queries' top 32 one-sided LC-RWMD candidates."""
    kw = dict(eps=0.05, eps_scaling=2, max_iters=100)
    c = make_corpus(table_iv_spec("set2", 0.01), device="cpu")
    docs, emb = c.docs, torch.as_tensor(c.emb)
    nq, k = 2, 32
    _, cand = tops.lc_rwmd_fused_topk(emb, docs.ids[:nq], docs.weights[:nq],
                                      docs.ids, docs.weights, k=k, fuse="jnp",
                                      row_block=4096)
    ci = cand.reshape(-1).long()
    qi = torch.arange(nq).repeat_interleave(k)
    ids1, w1, ids2, w2 = (docs.ids[ci], docs.weights[ci], docs.ids[qi],
                          docs.weights[qi])
    t1, t2 = emb[ids1.long()], emb[ids2.long()]
    port_k, iters = tsk.sinkhorn(t1, w1, t2, w2, **kw)
    port_b = twmd.wmd_batched(ids1, w1, ids2, w2, emb, **kw)
    ref_k = np.asarray(jops.sinkhorn_wmd(*(jnp.asarray(x.numpy()) for x in
                                           (t1, w1, t2, w2)),
                                         interpret=True, **kw))
    ref_b = np.asarray(jwmd.wmd_batched(*(jnp.asarray(x.numpy()) for x in
                                          (ids1, w1, ids2, w2, emb)), **kw))
    gap_ref = np.abs(ref_k - ref_b)
    gap_port = np.abs(port_k.numpy() - port_b.numpy())
    print(f"mean iterations {iters.float().mean().item():.1f} of "
          f"{2 * kw['max_iters']}; kernel - batched max |gap|: reference "
          f"{gap_ref.max():.4f}, port {gap_port.max():.4f}; port - reference: "
          f"kernel {np.abs(port_k.numpy() - ref_k).max():.2e}, batched "
          f"{np.abs(port_b.numpy() - ref_b).max():.2e}")
    assert float(iters.float().mean()) > 0.9 * 2 * kw["max_iters"]
    np.testing.assert_allclose(port_k.numpy(), ref_k, rtol=WMD_RTOL,
                               atol=GRAM_ATOL)
    np.testing.assert_allclose(port_b.numpy(), ref_b, rtol=WMD_RTOL,
                               atol=GRAM_ATOL)
    # the reference's own backends differ far beyond that tolerance, pair by
    # pair as the port's do
    assert gap_ref.max() > 2 * GRAM_ATOL
    np.testing.assert_allclose(gap_port, gap_ref, atol=2 * GRAM_ATOL)


def test_emd_exact_lp_matches_reference_and_bounds_sinkhorn():
    w1, w2, _, _, c = _wmd_problems(5, p=4)
    kw = dict(eps=0.005, eps_scaling=5, max_iters=2000, tol=1e-6)
    sk = twmd.sinkhorn_log_batched(_t(w1), _t(w2), _t(c), **kw).cost.numpy()
    for i in range(4):
        want = jwmd.emd_exact_lp(w1[i], w2[i], c[i])
        got = twmd.emd_exact_lp(_t(w1[i]), _t(w2[i]), _t(c[i]))
        assert abs(got - want) <= 1e-9 * max(1.0, abs(want))
        assert abs(sk[i] - got) <= 0.05 * max(got, 1e-3) + 1e-3


def test_dispatch_routes_as_the_reference():
    """use_kernel=False (the default) is the batched solver, absorb_every
    included; use_kernel=True is the kernel, which drops absorb_every."""
    w1, w2, t1, t2, _ = _wmd_problems(6, p=5)
    kw = dict(eps=0.05, eps_scaling=2, max_iters=60, absorb_every=3)
    got = twmd.wmd_batched_dispatch(_t(t1), _t(w1), _t(t2), _t(w2), **kw)
    assert torch.equal(got, twmd.wmd_batched_from_t(_t(t1), _t(w1), _t(t2),
                                                    _t(w2), **kw))
    want = jwmd.wmd_batched_dispatch(jnp.asarray(t1), jnp.asarray(w1),
                                     jnp.asarray(t2), jnp.asarray(w2), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WMD_ATOL)
    kern = twmd.wmd_batched_dispatch(_t(t1), _t(w1), _t(t2), _t(w2),
                                     use_kernel=True, **kw)
    kw.pop("absorb_every")
    assert torch.equal(kern, tops.sinkhorn_wmd(_t(t1), _t(w1), _t(t2), _t(w2),
                                               **kw))
    with pytest.raises(TypeError, match="unknown sinkhorn"):
        twmd.wmd_batched_dispatch(_t(t1), _t(w1), _t(t2), _t(w2), epsilon=1.0)


def test_pruned_wmd_topk_default_backend_matches_reference(corpus):
    """Without an engine the reference's default refine is the batched
    solver; the port's default must be the same solver."""
    jdocs, jemb, docs, emb = corpus
    kw = dict(eps=0.05, eps_scaling=2, max_iters=100, absorb_every=2)
    want = jpipe.pruned_wmd_topk(jdocs, jdocs[:6], jemb, k=4, sinkhorn_kw=kw)
    got = tpipe.pruned_wmd_topk(docs, docs[:6], emb, k=4, sinkhorn_kw=kw)
    np.testing.assert_allclose(got.topk.dists.numpy(),
                               np.asarray(want.topk.dists), rtol=RTOL,
                               atol=GRAM_ATOL)
    np.testing.assert_allclose(got.cutoff.numpy(), np.asarray(want.cutoff),
                               rtol=RTOL, atol=GRAM_ATOL)
    assert np.array_equal(got.topk.indices.numpy(), np.asarray(want.topk.indices))
    explicit = tpipe.pruned_wmd_topk(docs, docs[:6], emb, k=4, sinkhorn_kw=kw,
                                     use_kernel=False)
    assert torch.equal(got.topk.dists, explicit.topk.dists)
