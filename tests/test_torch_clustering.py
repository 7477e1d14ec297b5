"""The port's clustering against the reference's, on the CPU.

Both packages see ``tests/test_index.py``'s corpus (192 docs, vocab 512,
m 48), carried across by ``repro_torch.convert.from_numpy``; the engines
hold its first 160 docs.  The port runs ``device="cpu"`` (each kernel's
plain version), the reference its jnp engines.

Labels, medoids and iteration counts must be the reference's exactly.
Objectives: within 1e-5 relative where every distance is an exact
difference of centroids (the WCD baseline); within 1e-4 relative where
they are symmetric RWMD bounds, whose per-pair values differ between the
packages by the gram form's noise (up to 5.5e-3 on this corpus, most of it
on the medoids' distances to themselves; ``tests/test_torch_engine.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import lc_rwmd as jlc
from repro.data.docs import DocSet as JDocSet
from repro.data.synth import CorpusSpec, make_corpus
from repro.workloads import clustering as jc
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.kernels import rwmd_pairwise as trw
from repro_torch.workloads import clustering as tc

N = 160
K = 6
# Sinkhorn at eps 0.5, 2 levels of at most 30 iterations: on this corpus the
# reference's batched solver and the port's agree within 4.3e-3 there, as at
# 200 iterations a level, at a seventh of the iterations.
RERANK_KW = dict(eps=0.5, eps_scaling=2, max_iters=30, tol=1e-4)
KMEDOIDS = {
    "full": dict(),
    "prefilter": dict(prefilter=3),
    "rerank_wmd": dict(prefilter=2, rerank_wmd=True, sinkhorn_kw=RERANK_KW,
                       n_iters=2),
}


@pytest.fixture(scope="module")
def corpus():
    c = make_corpus(CorpusSpec(n_docs=192, vocab_size=512, emb_dim=48,
                               h_max=16, mean_h=8.0, n_classes=4, seed=3))
    docs, emb = from_numpy(np.asarray(c.docs.ids), np.asarray(c.docs.weights),
                           c.emb, device="cpu")
    return c, docs, emb


def _engines(corpus, kind):
    c, docs, emb = corpus
    jdocs = JDocSet(ids=c.docs.ids[:N], weights=c.docs.weights[:N])
    if kind == "segmented":
        return (jlc.SegmentedEngine(jdocs, c.emb),
                tlc.SegmentedEngine(docs[:N], emb, device="cpu"))
    return (jlc.LCRWMDEngine(jdocs, c.emb),
            tlc.LCRWMDEngine(docs[:N], emb, device="cpu"))


@pytest.fixture(scope="module")
def seg(corpus):
    return _engines(corpus, "segmented")


@pytest.fixture(scope="module")
def mono(corpus):
    return _engines(corpus, "monolithic")


@pytest.mark.parametrize("kind", ["segmented", "monolithic"])
@pytest.mark.parametrize("seed", [0, 5, None])
def test_kcenters_matches_reference(request, kind, seed):
    ref, port = request.getfixturevalue("seg" if kind == "segmented"
                                        else "mono")
    want = jc.kcenters(ref, K, seed=seed)
    got = tc.kcenters(port, K, seed=seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", sorted(KMEDOIDS))
def test_kmedoids_matches_reference(seg, mode):
    ref, port = seg
    want = jc.kmedoids(ref, K, seed=0, **KMEDOIDS[mode])
    got = tc.kmedoids(port, K, seed=0, **KMEDOIDS[mode])
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.medoids, want.medoids)
    assert got.n_iters == want.n_iters
    assert got.labels.dtype == np.int32 and got.medoids.dtype == np.int32
    assert abs(got.objective - want.objective) <= 1e-4 * abs(want.objective)


def test_kmedoids_monolithic_and_init_match_reference(mono):
    ref, port = mono
    init = np.array([3, 40, 77, 101, 130, 150], np.int32)
    want = jc.kmedoids(ref, K, init=init, n_iters=3)
    got = tc.kmedoids(port, K, init=init, n_iters=3)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.medoids, want.medoids)
    assert got.n_iters == want.n_iters


@pytest.mark.parametrize("n_clusters", [1, K, 11])
def test_kmedoids_wcd_baseline_matches_reference(seg, n_clusters):
    ref, port = seg
    want = jc.kmedoids_wcd_baseline(ref, n_clusters)
    got = tc.kmedoids_wcd_baseline(port, n_clusters)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.medoids, want.medoids)
    assert got.n_iters == want.n_iters
    assert abs(got.objective - want.objective) <= 1e-5 * abs(want.objective)


def test_exact_dists_are_the_norm_of_differences(seg, monkeypatch):
    _, port = seg
    from repro_torch.core.wcd import resident_centroids

    monkeypatch.setattr(tc, "_ROWS", 16)
    cen = resident_centroids(port.resident, port.emb_full)
    a, b = cen[:50], cen[100:107]
    want = np.linalg.norm(a.numpy()[:, None] - b.numpy()[None], axis=2)
    got = tc.exact_dists(a, b)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", range(4))
def test_purity_and_ari_match_reference(corpus, seg, case):
    c = corpus[0]
    truth = np.asarray(c.labels)[:N]
    rng = np.random.default_rng(case)
    preds = [truth, jc.kcenters(seg[0], K, seed=0)[rng.integers(0, K, N)],
             rng.integers(0, 7, N), np.zeros(N, np.int64)]
    pred = preds[case]
    assert tc.purity(pred, truth) == jc.purity(pred, truth)
    assert tc.adjusted_rand_index(pred, truth) == jc.adjusted_rand_index(
        pred, truth)


def test_clustering_skips_deleted_docs(corpus):
    """A deleted doc is never a center or a medoid and is left out of the
    objective (the reference would pick it: its column is +inf)."""
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:N], emb, device="cpu")
    full = tc.kcenters(eng, K, seed=0)
    dead = np.array([full[1], full[3], 0, 159])
    eng.delete(dead)
    centers = tc.kcenters(eng, K, seed=0)
    assert len(set(centers.tolist())) == K
    assert not np.isin(centers, dead).any()
    res = tc.kmedoids(eng, K, seed=0, n_iters=3)
    assert not np.isin(res.medoids, dead).any()
    assert np.isfinite(res.objective)
    live = eng.live_mask()
    assert len(np.unique(res.labels[live])) == K


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


def assert_no_corpus_sized_gather(shapes, n, h, m, n_clusters):
    """No tensor of n·h·m or n·C·m elements, and none shaped as the
    reference's (n, h, m) / (n·h, m) gather or (n, C, m) broadcast."""
    bad = [s for s in shapes
           if int(np.prod(s)) in (n * h * m, n * n_clusters * m)
           or (len(s) >= 2 and s[-1] == m and s[0] in (n, n * h, n * n_clusters)
               and int(np.prod(s)) >= n * min(h, n_clusters) * m)]
    assert not bad, bad[:5]


def test_footprint_no_corpus_sized_gather(corpus, monkeypatch):
    """kcenters, both kmedoids paths and the WCD baseline, under an op-shape
    trace with every chunk smaller than the corpus."""
    _, docs, emb = corpus
    monkeypatch.setattr(tc, "_ROWS", 32)
    monkeypatch.setattr(trw, "_PLAIN_DOCS", 32)
    import repro_torch.core.wcd as twcd
    monkeypatch.setattr(twcd, "_CENTROID_ROWS", 32)
    eng = tlc.SegmentedEngine(docs[:N], emb, device="cpu", row_block=32)
    with _Shapes() as rec:
        tc.kcenters(eng, K, seed=0)
        tc.kmedoids(eng, K, seed=0, n_iters=1)
        tc.kmedoids(eng, K, seed=0, n_iters=1, prefilter=3)
        tc.kmedoids_wcd_baseline(eng, K, n_iters=1)
    assert len(rec.shapes) > 100
    assert_no_corpus_sized_gather(rec.shapes, N, docs.h_max, emb.shape[1], K)


def test_footprint_probe_catches_the_reference_gather(corpus):
    """The probe sees the reference's (n·h, m) gather when it is built."""
    _, docs, emb = corpus
    with _Shapes() as rec:
        emb[docs.ids[:N].reshape(-1).long()]
    with pytest.raises(AssertionError):
        assert_no_corpus_sized_gather(rec.shapes, N, docs.h_max,
                                      emb.shape[1], K)
