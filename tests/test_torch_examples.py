"""The port's examples and serving launcher on the CPU, against the
reference's functions on the same corpora; and the order of non-finite
distances in the top-k, against the reference's jnp path.

Each entry point runs through its ``main(["--device", "cpu", ...])`` and
returns the numbers it prints: at the reference's sizes, but for
``knn_classify`` (128 docs and 16 queries: its WMD cascade on the CPU, in
both packages, is the cost) and ``serve_queries`` and the launcher (512
docs).  Ids are compared where the reference's neighbouring gaps exceed
1e-2 (the gram form's noise, ROADMAP C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_classify as j_knn_classify
from repro.core import lc_rwmd_symmetric as j_symmetric
from repro.core import pruned_wmd_topk as j_pruned_wmd_topk
from repro.core import topk_smallest as j_topk_smallest
from repro.core import wcd_many_vs_many as j_wcd
from repro.data.docs import DocSet as JDocSet
from repro.data.synth import CorpusSpec, make_bimodal_corpus, make_corpus
from repro_torch.convert import from_numpy
from repro_torch.core import LCRWMDEngine
from repro_torch.core import topk as ttopk
from repro_torch.data.docs import DocSet
from repro_torch.examples import (cluster_corpus, knn_classify, quickstart,
                                  serve_queries)
from repro_torch.launch import serve as launcher

CPU = ["--device", "cpu"]


def _ids_apart(got_ids, want_d, want_i, gap=1e-2):
    wd, wi = np.asarray(want_d), np.asarray(want_i)
    apart = np.ones(wd.shape, bool)
    g = np.diff(wd, axis=1) > gap
    apart[:, 1:] &= g
    apart[:, :-1] &= g
    np.testing.assert_array_equal(np.asarray(got_ids)[apart], wi[apart])


def test_quickstart_matches_reference():
    out = quickstart.main(CPU)
    c = make_corpus(CorpusSpec(n_docs=2000, vocab_size=4096, emb_dim=64,
                               h_max=24, mean_h=14.0, n_classes=8, seed=0))
    want = j_topk_smallest(j_symmetric(c.docs, c.docs[:4],
                                       jnp.asarray(c.emb)).T, 5)
    _ids_apart(out["top_ids"], want.dists, want.indices)
    np.testing.assert_allclose(out["top_dists"], np.asarray(want.dists),
                               rtol=1e-4, atol=2.5e-2)
    assert list(out["top_ids"][:, 0]) == [0, 1, 2, 3]
    assert out["lc_vs_quadratic_max_diff"] < 2.5e-2 and out["rwmd_le_wmd"]


def test_knn_classify_matches_reference():
    """The three kNN accuracies (WCD, LC-RWMD, the pruned WMD cascade)
    against the reference's functions on the same corpus, within one
    query; the reference's cascade runs once, at the budget the port's
    adaptive loop ended at (its last call decides the answer)."""
    n_docs, n_test, k = 128, 16, 7
    out = knn_classify.main(CPU + ["--n-docs", str(n_docs), "--n-test",
                                   str(n_test)])
    c = make_corpus(CorpusSpec(n_docs=n_docs, vocab_size=2048, emb_dim=48,
                               h_max=16, mean_h=10.0, n_classes=4, seed=9))
    docs, emb, labels = c.docs, jnp.asarray(c.emb), jnp.asarray(c.labels)
    queries = docs[:n_test]
    diag = jnp.arange(n_test)

    def acc(pred):
        return float(np.mean(np.asarray(pred) == c.labels[:n_test]))

    d = j_wcd(docs, queries, emb).T.at[diag, diag].set(jnp.inf)
    a_wcd = acc(j_knn_classify(j_topk_smallest(d, k), labels, 4))
    d = j_symmetric(docs, queries, emb).T.at[diag, diag].set(jnp.inf)
    a_rwmd = acc(j_knn_classify(j_topk_smallest(d, k), labels, 4))
    res = j_pruned_wmd_topk(docs, queries, emb, k=k + 1,
                            refine_budget=out["budget"],
                            sinkhorn_kw=dict(eps=0.02, eps_scaling=3,
                                             max_iters=150))
    idx = np.asarray(res.topk.indices)
    preds = [np.bincount(c.labels[[i for i in idx[j] if i != j][:k]],
                         minlength=4).argmax() for j in range(n_test)]
    for got, want in ((out["acc_wcd"], a_wcd), (out["acc_rwmd"], a_rwmd),
                      (out["acc_wmd"], acc(preds))):
        assert abs(got - want) <= 1 / n_test + 1e-9, (out, a_wcd, a_rwmd)
    assert out["acc_wmd"] > 0.25


def test_cluster_corpus_matches_reference():
    from repro.core import LCRWMDEngine as JEngine
    from repro.workloads import (adjusted_rand_index, duplicate_groups,
                                 kcenters, kmedoids, near_duplicate_graph)

    out = cluster_corpus.main(CPU)
    c = make_bimodal_corpus(CorpusSpec(
        n_docs=256, vocab_size=1024, emb_dim=32, h_max=24, mean_h=16.0,
        n_classes=4, topic_noise=0.1, seed=17))
    ids, w = np.array(c.docs.ids), np.array(c.docs.weights)
    for dst, src in ((3, 200), (4, 200), (9, 150)):
        ids[dst], w[dst] = ids[src], w[src]
    eng = JEngine(JDocSet(ids=jnp.asarray(ids), weights=jnp.asarray(w)),
                  jnp.asarray(c.emb))
    seeds = kcenters(eng, 4)
    res = kmedoids(eng, 4, n_iters=8, init=seeds)
    groups = [sorted(g.tolist()) for g in duplicate_groups(
        near_duplicate_graph(eng, 0.05, tile=64))]
    np.testing.assert_array_equal(out["seeds"], seeds)
    assert out["groups"] == groups == [[3, 4, 200], [9, 150]]
    np.testing.assert_array_equal(out["medoids"], res.medoids)
    assert out["ari"] == pytest.approx(
        adjusted_rand_index(res.labels, c.labels), abs=1e-9)
    assert out["ari"] > out["ari_wcd"] + 0.3


@pytest.mark.parametrize("argv", [[], ["--async", "--rerank-wmd"]])
def test_serve_queries_holds_its_recall(argv):
    """The example's own gate (recall@8 > 0.9, asserted in ``main``), here
    at 512 docs and 16 queries; sync and async, the latter with the WMD
    rerank."""
    out = serve_queries.main(CPU + ["--n-docs", "512", "--n-queries", "16",
                                    *argv])
    assert out["n_served"] == 16 and out["recall"] > 0.9


def test_launcher_serves_and_refuses_the_mesh_flags():
    """``--multi-pod`` alone serves as without it; ``--full`` builds the
    production mesh, whose ``ValueError`` refuses a world of one rank
    (``tests/test_torch_cells.py`` holds the cell it builds)."""
    out = launcher.main(CPU + ["--n-docs", "512", "--n-queries", "16",
                               "--k", "5", "--multi-pod"])
    assert out["n_served"] == 16 and out["self_recall"] == 1.0
    with pytest.raises(ValueError, match="16x16 > 1 ranks"):
        launcher.main(CPU + ["--full"])


# ---------------------------------------------------------------------------
# Non-finite distances in the top-k (the fused top-k's order, on the CPU)
# ---------------------------------------------------------------------------
def test_merge_ranks_unfilled_slots_after_inf_and_nan():
    a = ttopk.TopK(torch.tensor([[1.0, float("inf")]]),
                   torch.tensor([[3, 4]], dtype=torch.int32))
    b = ttopk.TopK(torch.tensor([[3.4e38, float("nan")]]),
                   torch.tensor([[-1, 7]], dtype=torch.int32))
    c = ttopk.TopK(torch.tensor([[float("inf"), float("nan")]]),
                   torch.tensor([[-1, 2]], dtype=torch.int32))
    got = ttopk.merge_topk([a, b, c], 6)
    assert got.indices.tolist() == [[3, 4, 2, 7, -1, -1]]
    d = got.dists[0]
    assert d[0] == 1.0 and torch.isinf(d[1]) and torch.isnan(d[2:4]).all()


@pytest.fixture(scope="module")
def nan_corpus(small_corpus):
    c = small_corpus
    ids, w = np.asarray(c.docs.ids), np.asarray(c.docs.weights)
    return c, ids, w


def test_nonfinite_embedding_row_ranks_last_with_its_ids(nan_corpus):
    """A NaN embedding row: in the port every doc that holds that word at a
    positive weight has a NaN one-sided distance (its Z row is NaN).  With
    k covering every doc, the port's fold (the fused top-k's plain version)
    ranks those docs after the finite ones, by id, at NaN, and no unfilled
    slot.  The other docs hold the reference's jnp-path order and
    distances; the reference's jnp path, on this container, does not carry
    the NaN row into those docs' distances and ranks them among the finite
    ones, so they are taken out of its list before the comparison."""
    from repro.core import LCRWMDEngine as JEngine

    c, ids, w = nan_corpus
    held = np.array([((ids == v) & (w > 0)).any(1).sum() for v in range(512)])
    word = int(np.flatnonzero((held >= 5) & (held <= 20))[0])
    hit = ((ids == word) & (w > 0)).any(1)
    qrows = np.flatnonzero(~hit)[:4]
    emb = c.emb.copy()
    emb[word] = np.nan
    docs, temb = from_numpy(ids, w, emb, device="cpu")
    eng = LCRWMDEngine(docs, temb, device="cpu")
    got = eng.topk_streaming(docs[torch.as_tensor(qrows)], 96)
    want = JEngine(c.docs, jnp.asarray(emb)).topk_streaming(
        JDocSet(ids=c.docs.ids[qrows], weights=c.docs.weights[qrows]), 96)
    n_fin = 96 - int(hit.sum())
    gd, gi = got.dists.numpy(), got.indices.numpy()
    wd, wi = np.asarray(want.dists), np.asarray(want.indices)
    rest = ~np.isin(wi, np.flatnonzero(hit))
    wd, wi = wd[rest].reshape(4, n_fin), wi[rest].reshape(4, n_fin)
    _ids_apart(gi[:, :n_fin], wd, wi)
    np.testing.assert_allclose(gd[:, :n_fin], wd, rtol=1e-4, atol=2.5e-2)
    assert np.isnan(gd[:, n_fin:]).all()
    assert (gi[:, n_fin:] == np.flatnonzero(hit)[None, :]).all()


def test_nan_query_weight_is_dropped_as_on_the_card(nan_corpus):
    """A query with one NaN weight, through ``symmetric_topk_streaming`` and
    the refined serve step: phase 1 lists only words with ``w > 0`` in
    both packages, and so do the port's swapped direction (the d21 mode's
    kernel and its plain version alike), so the port serves that query as
    if the word were absent: finite, equal to the query with the weight
    set to 0, and no NaN reaches the fused top-k.  The reference's jnp
    path multiplies the NaN weight into every doc's swapped direction: its
    streaming top-k returns its (+inf, -1) filler for that query, and its
    refined serve step the same candidate ids as the port at NaN.  The
    other queries hold the reference's ids and distances."""
    from repro.core import LCRWMDEngine as JEngine
    from repro.distributed.lcrwmd_dist import build_serve_step as j_step
    from repro.launch.mesh import make_host_mesh
    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    c, ids, w = nan_corpus
    q_ids, q_w = ids[:4].copy(), w[:4].copy()
    q_w[1, 0] = np.nan
    docs, emb = from_numpy(ids, w, c.emb, device="cpu")
    eng = LCRWMDEngine(docs, emb, device="cpu")
    tq = DocSet(ids=torch.tensor(q_ids), weights=torch.tensor(q_w))
    dropped = DocSet(ids=tq.ids, weights=torch.nan_to_num(tq.weights))
    je = JEngine(c.docs, jnp.asarray(c.emb))
    jq = JDocSet(ids=jnp.asarray(q_ids), weights=jnp.asarray(q_w))
    ok = [0, 2, 3]

    got = eng.symmetric_topk_streaming(tq, 5)
    want = je.symmetric_topk_streaming(jq, 5)
    base = eng.symmetric_topk_streaming(dropped, 5)
    assert torch.equal(got.indices, base.indices)
    assert torch.equal(got.dists, base.dists)
    assert torch.isfinite(got.dists).all()
    assert (np.asarray(want.indices)[1] == -1).all()
    _ids_apart(got.indices.numpy()[ok], np.asarray(want.dists)[ok],
               np.asarray(want.indices)[ok])

    got = build_serve_step(k=5, engine=eng, refine=True, device="cpu")(tq)
    want = j_step(make_host_mesh(data=1, model=1), k=5, engine=je,
                  refine=True)(jq)
    gi, wi = got.topk.indices.numpy(), np.asarray(want.topk.indices)
    assert np.isnan(np.asarray(want.topk.dists)[1]).all()
    assert sorted(gi[1]) == sorted(wi[1])
    assert torch.isfinite(got.topk.dists).all()
    _ids_apart(gi[ok], np.asarray(want.topk.dists)[ok], wi[ok])
