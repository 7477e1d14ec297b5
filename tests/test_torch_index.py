"""The port's cluster index, routed cascade and routed serve step against
the reference's, on the CPU.

Both packages see ``tests/test_index.py``'s corpus and engine: 160 docs
plus a copy of doc 5 (a genuine tie), 6 cells, queries 4-19.  The port
runs ``device="cpu"`` (each kernel's plain version), the reference its jnp
engine and, for the serve step, ``make_host_mesh()``.

Against the reference: labels, routed cells, keep masks and pruned counts
exactly; result ids exactly; distances within ``test_torch_engine``'s
tolerance (2.5e-2 absolute, the gram form's noise near zero, plus 1e-4
relative), since the two packages' symmetric bounds differ by up to
9.7e-3 on a self-match and 4.4e-4 relative elsewhere on this corpus.
Within the port, exhaustive routing (``top_p = num_cells``, bound off)
equals the flat segmented scan bit for bit.  For the symmetric fold the
engines take ``row_block=1``: the CPU fold's swapped direction is a plain
GEMM per slab of rows, whose last bit can move when the slab's width
does, and cells cut the corpus into other slabs than its segment (one
ulp, 9.5e-7, at the default 128; ROADMAP C).  The card's kernels fix
their sum orders per row, so ``tests/test_torch_cuda.py`` holds the card
to bit equality at any slab.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lc_rwmd as jlc
from repro.core import pipeline as jpipe
from repro.data.docs import DocSet as JDocSet
from repro.data.synth import CorpusSpec, make_corpus
from repro.distributed import lcrwmd_dist as jd
from repro.index import ClusterIndex as JIndex
from repro.launch.mesh import make_host_mesh
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.core import pipeline as tpipe
from repro_torch.data.docs import DocSet
from repro_torch.distributed import lcrwmd_dist as td
from repro_torch.index import ClusterIndex, IndexConfig
from test_torch_clustering import _Shapes, assert_no_corpus_sized_gather
from test_torch_engine import ATOL, RTOL, _np

K = 8
N_CELLS = 6
# Sinkhorn at eps 0.5, 2 levels of at most 30 iterations: on this corpus the
# reference's batched solver and the port's agree within 4.3e-3 there, as at
# 200 iterations a level, at a seventh of the iterations.
RERANK_KW = dict(eps=0.5, eps_scaling=2, max_iters=30, tol=1e-4)
ROUTES = [(2, None), (3, 1.0), (6, None), (6, 1.0), (6, 0.5)]


@pytest.fixture(scope="module")
def corpus():
    c = make_corpus(CorpusSpec(n_docs=192, vocab_size=512, emb_dim=48,
                               h_max=16, mean_h=8.0, n_classes=4, seed=3))
    docs, emb = from_numpy(np.asarray(c.docs.ids), np.asarray(c.docs.weights),
                           c.emb, device="cpu")
    return c, docs, emb


def _jslice(c, lo, hi):
    return JDocSet(ids=c.docs.ids[lo:hi], weights=c.docs.weights[lo:hi])


def _port_engine(docs, emb, **kw):
    base = DocSet(torch.cat([docs.ids[:160], docs.ids[5:6]]),
                  torch.cat([docs.weights[:160], docs.weights[5:6]]))
    return tlc.SegmentedEngine(base, emb, device="cpu", **kw)


@pytest.fixture(scope="module")
def engines(corpus):
    """(reference engine, port engine, port engine at row_block 1)."""
    c, docs, emb = corpus
    jbase = JDocSet(ids=jnp.concatenate([c.docs.ids[:160], c.docs.ids[5:6]]),
                    weights=jnp.concatenate([c.docs.weights[:160],
                                             c.docs.weights[5:6]]))
    return (jlc.SegmentedEngine(jbase, c.emb), _port_engine(docs, emb),
            _port_engine(docs, emb, row_block=1))


@pytest.fixture(scope="module")
def indexes(engines):
    ref, port, port1 = engines
    kw = dict(num_cells=N_CELLS, top_p=N_CELLS, probe_cap=N_CELLS, seed=0)
    return JIndex(ref, **kw), ClusterIndex(port, **kw), ClusterIndex(port1, **kw)


@pytest.fixture(scope="module")
def queries(corpus):
    c, docs, _ = corpus
    return _jslice(c, 4, 20), docs[4:20]   # doc 5 = the tie maker


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


def assert_topk_ref(got, want):
    """The reference's ids exactly; distances within the packages' noise."""
    np.testing.assert_array_equal(_np(got.indices), _np(want.indices))
    np.testing.assert_allclose(_np(got.dists), _np(want.dists), rtol=RTOL,
                               atol=ATOL)


def assert_bit_equal(a, b):
    assert torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)


# ---------------------------------------------------------------------------
# Partition
# ---------------------------------------------------------------------------
def test_kcenters_labels_match_reference(indexes):
    ji, ti, _ = indexes
    assert ti.labels.dtype == np.int32
    np.testing.assert_array_equal(ti.labels, ji.labels)


def test_kmedoids_labels_match_reference_and_are_deterministic(engines):
    ref, port, _ = engines
    want = JIndex(ref, num_cells=4, seed=7, method="kmedoids").labels
    a = ClusterIndex(port, num_cells=4, seed=7, method="kmedoids")
    b = ClusterIndex(port, num_cells=4, seed=7, method="kmedoids")
    np.testing.assert_array_equal(a.labels, want)
    np.testing.assert_array_equal(b.labels, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_partition_deterministic_across_rebuilds(engines, seed):
    _, port, _ = engines
    idx = ClusterIndex(port, num_cells=N_CELLS, seed=seed)
    before, v = idx.labels.copy(), idx.version
    idx.rebuild()
    np.testing.assert_array_equal(idx.labels, before)
    assert idx.version == v + 1
    twin = ClusterIndex(port, num_cells=N_CELLS, seed=seed)
    np.testing.assert_array_equal(twin.labels, before)


def test_cells_unpadded_and_counted(indexes):
    _, ti, _ = indexes
    cells = [c for c in ti.cells if c is not None]
    sizes = [c.segment.n_rows for c in cells]
    assert sum(sizes) == ti.engine.n_docs and ti.rows_cap == max(sizes)
    for j, c in enumerate(ti.cells):
        if c is None:
            continue
        np.testing.assert_array_equal(c.members, np.nonzero(ti.labels == j)[0])
        assert torch.equal(c.gids.long(), torch.from_numpy(c.members))
        # each cell's own vocabulary: the words its members use, no padding
        w = c.segment.tensors.r_w
        assert c.segment.tensors.emb_r.shape[0] == len(torch.unique(
            c.segment.docs.ids[w > 0]))
    held = sum(c.segment.nbytes + c.segment.n_rows for c in cells)
    assert ti.nbytes == held + ti.centroid_nbytes
    assert ti.centroid_nbytes >= ti.doc_centroids.numel() * 4


# ---------------------------------------------------------------------------
# Routing and the routed top-k
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("top_p,slack", ROUTES)
def test_route_matches_reference(indexes, queries, top_p, slack):
    ji, ti, _ = indexes
    jq, tq = queries
    want = ji.route(jq, top_p=top_p, bound_slack=slack)
    got = ti.route(tq, top_p=top_p, bound_slack=slack)
    np.testing.assert_array_equal(got.cells, want.cells)
    np.testing.assert_array_equal(got.keep, want.keep)
    np.testing.assert_array_equal(got.probed, want.probed)
    assert (got.n_bound_pruned, got.n_docs_pruned) == (
        want.n_bound_pruned, want.n_docs_pruned)


@pytest.mark.parametrize("top_p,slack", ROUTES)
def test_routed_topk_matches_reference(indexes, queries, top_p, slack):
    ji, ti, _ = indexes
    jq, tq = queries
    got = ti.routed_topk(tq, K, top_p=top_p, bound_slack=slack)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (16, K)
    assert_topk_ref(got, ji.routed_topk(jq, K, top_p=top_p,
                                        bound_slack=slack))


def test_exhaustive_routing_bit_equals_flat_scan(engines, indexes, queries):
    _, port, port1 = engines
    _, ti, ti1 = indexes
    _, tq = queries
    got = ti1.routed_topk(tq, K, top_p=N_CELLS, bound_slack=None)
    assert_bit_equal(got, port1.topk(tq, K))
    # the one-sided fold is bit-equal at any slab
    r = ti.route(tq, top_p=N_CELLS, bound_slack=None)
    assert_bit_equal(ti.fold_cells(tq, K, r.probed, r.cells, r.keep,
                                   symmetric=False),
                     port.topk_streaming(tq, K))
    # at the default slab: the same ids, the last bit of the swapped
    # direction's per-slab GEMM aside
    a, b = ti.routed_topk(tq, K, top_p=N_CELLS, bound_slack=None), port.topk(tq, K)
    assert torch.equal(a.indices, b.indices)
    torch.testing.assert_close(a.dists, b.dists, rtol=1e-6, atol=1e-6)


def test_cell_on_a_query_subset_equals_the_cell_on_all(indexes, queries):
    """A cell run on its routed queries only gives those rows of the cell
    run on every query; the other rows are (+inf, -1)."""
    _, _, ti1 = indexes
    _, tq = queries
    c = next(j for j, cell in enumerate(ti1.cells) if cell is not None)
    cells = np.full((16, 1), c, dtype=np.int32)
    every = ti1.fold_cells(tq, K, [c], cells, np.ones((16, 1), bool),
                           symmetric=True)
    keep = np.zeros((16, 1), bool)
    keep[[1, 4, 9]] = True
    some = ti1.fold_cells(tq, K, [c], cells, keep, symmetric=True)
    rows = torch.tensor([1, 4, 9])
    assert_bit_equal(type(some)(some.dists[rows], some.indices[rows]),
                     type(every)(every.dists[rows], every.indices[rows]))
    others = torch.tensor([j for j in range(16) if j not in (1, 4, 9)])
    assert bool(torch.isinf(some.dists[others]).all())
    assert bool((some.indices[others] == -1).all())


# ---------------------------------------------------------------------------
# The routed cascade
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("top_p", [2, N_CELLS])
def test_pipeline_routed_matches_reference(corpus, engines, indexes, queries,
                                           top_p):
    c, _, emb = corpus
    ref, port, _ = engines
    ji, ti, _ = indexes
    jq, tq = queries
    kw = dict(k=K, refine_budget=2 * K, sinkhorn_kw=RERANK_KW)
    want = jpipe.pruned_wmd_topk(ref.resident, jq, c.emb, engine=ref,
                                 index=ji, top_p=top_p, **kw)
    got = tpipe.pruned_wmd_topk(port.resident, tq, emb, index=ti,
                                top_p=top_p, **kw)
    assert_topk_ref(got.rwmd_topk, want.rwmd_topk)
    assert_topk_ref(got.topk, want.topk)
    assert np.array_equal(_np(got.pruned_exact), _np(want.pruned_exact))


def test_pipeline_exhaustive_routing_bit_equals_flat(corpus, engines, indexes,
                                                     queries):
    _, _, emb = corpus
    _, _, port1 = engines
    _, _, ti1 = indexes
    _, tq = queries
    kw = dict(k=K, refine_budget=2 * K, sinkhorn_kw=RERANK_KW)
    flat = tpipe.pruned_wmd_topk(port1.resident, tq, emb, engine=port1, **kw)
    routed = tpipe.pruned_wmd_topk(port1.resident, tq, emb, index=ti1,
                                   top_p=N_CELLS, **kw)
    for name in ("topk", "rwmd_topk"):
        assert_bit_equal(getattr(routed, name), getattr(flat, name))
    for name in ("pruned_exact", "n_refined", "cutoff"):
        assert torch.equal(getattr(routed, name), getattr(flat, name))
    # the whole corpus as budget, every cell routed: certified
    port, ti = engines[1], indexes[1]
    full = tpipe.pruned_wmd_topk(port.resident, tq[:2], emb, index=ti, k=K,
                                 refine_budget=port.n_docs, top_p=N_CELLS,
                                 sinkhorn_kw=RERANK_KW)
    assert bool(full.pruned_exact.all())


# ---------------------------------------------------------------------------
# The routed serve step
# ---------------------------------------------------------------------------
SERVE_KW = dict(k=K, refine=True, bf16_matmul=False, rerank_wmd=True,
                rerank_budget=2 * K, wmd_kw=RERANK_KW)


@pytest.mark.parametrize("tier", [0, 1, 2])
@pytest.mark.parametrize("top_p,cap", [(6, 6), (2, 6), (2, 2)])
def test_serve_step_routed_matches_reference(engines, queries, mesh, tier,
                                             top_p, cap):
    ref, port, _ = engines
    jq, tq = queries
    kw = dict(num_cells=N_CELLS, top_p=top_p, probe_cap=cap, seed=0)
    want = jd.build_serve_step(mesh, engine=ref, index=JIndex(ref, **kw),
                               streaming=True, **SERVE_KW)(jq, tier=tier)
    got = td.build_serve_step(engine=port, index=ClusterIndex(port, **kw),
                              **SERVE_KW)(tq, tier=tier)
    assert got.tier == want.tier == tier
    assert_topk_ref(got.topk, want.topk)
    if tier == 0:
        assert np.array_equal(_np(got.pruned_exact), _np(want.pruned_exact))


def test_serve_step_self_exclude_matches_reference(engines, indexes, queries,
                                                   mesh):
    ref, port, _ = engines
    ji, ti, _ = indexes
    jq, tq = queries
    kw = dict(SERVE_KW, self_exclude=True)
    want = jd.build_serve_step(mesh, engine=ref, index=ji, streaming=True,
                               **kw)(jq, jnp.arange(4, 20))
    got = td.build_serve_step(engine=port, index=ti, **kw)(
        tq, np.arange(4, 20))
    assert_topk_ref(got.topk, want.topk)
    ids = _np(got.topk.indices)
    assert not (ids == np.arange(4, 20)[:, None]).any()


@pytest.mark.parametrize("tier", [0, 1, 2, "self_exclude"])
def test_serve_step_exhaustive_bit_equals_flat(engines, indexes, queries,
                                               tier):
    _, port, _ = engines
    _, ti, _ = indexes
    _, tq = queries
    if tier == "self_exclude":
        kw, args = dict(SERVE_KW, self_exclude=True), (tq, np.arange(4, 20))
        tier = 0
    else:
        kw, args = SERVE_KW, (tq,)
    flat = td.build_serve_step(engine=port, **kw)(*args, tier=tier)
    routed = td.build_serve_step(engine=port, index=ti, **kw)(*args, tier=tier)
    assert_bit_equal(routed.topk, flat.topk)
    if tier == 0:
        assert torch.equal(routed.pruned_exact, flat.pruned_exact)


def test_serve_step_q_gid_per_cell(corpus):
    """Self-exclusion reaches each cell as the query's row there: a member
    excludes itself, a non-member excludes nothing, a deleted self stays
    out through the live mask."""
    _, docs, emb = corpus
    eng = _port_engine(docs, emb)
    idx = ClusterIndex(eng, num_cells=N_CELLS, top_p=N_CELLS,
                       probe_cap=N_CELLS, seed=0)
    q = docs[4:20]
    ids = np.arange(4, 20)
    ids_foreign = ids.copy()
    ids_foreign[0] = 150          # query 4 excludes doc 150 instead
    eng.delete([7])               # query 7's own doc
    step = td.build_serve_step(engine=eng, index=idx, self_exclude=True,
                               **SERVE_KW)
    flat = td.build_serve_step(engine=eng, self_exclude=True, **SERVE_KW)
    for qid in (ids, ids_foreign):
        got = step(q, qid, tier=1).topk
        assert_bit_equal(got, flat(q, qid, tier=1).topk)
        assert not (_np(got.indices) == qid[:, None]).any()
        assert 7 not in _np(got.indices)
    got = step(q, ids_foreign, tier=1).topk
    assert 4 == int(got.indices[0, 0])    # not excluded: finds itself


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------
def test_ingest_add_keeps_parity(corpus):
    c, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:128], emb, device="cpu", row_block=1)
    idx = ClusterIndex(eng, num_cells=4, top_p=4, probe_cap=4, seed=0)
    ref = jlc.SegmentedEngine(_jslice(c, 0, 128), c.emb)
    jidx = JIndex(ref, num_cells=4, top_p=4, probe_cap=4, seed=0)
    v = idx.version
    gids = eng.append(docs[128:150])
    assign = idx.add(gids, docs[128:150])
    want = jidx.add(ref.append(_jslice(c, 128, 150)), _jslice(c, 128, 150))
    assert assign.shape == (22,) and idx.version == v + 1
    np.testing.assert_array_equal(assign, want)
    np.testing.assert_array_equal(idx.labels, jidx.labels)
    # exhaustive routing after add: the port's flat scan bit for bit (the
    # reference's own bit-parity claim here fails on this jax: ROADMAP C)
    got = idx.routed_topk(docs[130:138], K, top_p=4, bound_slack=None)
    assert_bit_equal(got, eng.topk(docs[130:138], K))


def test_delete_honoured_without_index_call(corpus):
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:128], emb, device="cpu")
    idx = ClusterIndex(eng, num_cells=4, top_p=4, probe_cap=4, seed=0)
    q = docs[17:18]
    assert 17 in _np(idx.routed_topk(q, K).indices)[0]
    v = idx.version
    eng.delete([17])
    tk = idx.routed_topk(q, K)
    assert 17 not in _np(tk.indices)[0] and idx.version == v
    step = td.build_serve_step(engine=eng, index=idx, k=K, bf16_matmul=False)
    assert 17 not in _np(step(q).topk.indices)[0]


def test_unindexed_engine_append_raises(corpus):
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:128], emb, device="cpu")
    idx = ClusterIndex(eng, num_cells=4, seed=0)
    step = td.build_serve_step(engine=eng, index=idx, k=K, bf16_matmul=False)
    step(docs[:4])
    eng.append(docs[128:132])     # bypasses the index
    with pytest.raises(RuntimeError, match="appended directly"):
        idx.route(docs[:4])
    for tier in (0, 2):
        with pytest.raises(RuntimeError, match="appended directly"):
            step(docs[:4], tier=tier)


def test_bound_stage_prunes_and_keeps_self_matches(corpus):
    """(The pruned counts against the reference: test_route_matches_reference.)"""
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:160], emb, device="cpu")
    idx = ClusterIndex(eng, num_cells=8, top_p=8, probe_cap=8, seed=0,
                       bound_slack=1.0)
    route = idx.route(docs[10:26])
    assert route.n_bound_pruned > 0 and route.n_docs_pruned > 0
    ids = _np(idx.routed_topk(docs[10:26], K, route=route).indices)
    for i, g in enumerate(range(10, 26)):
        assert g in ids[i]


def test_rebuild_after_compact_is_a_fresh_index(corpus):
    _, docs, emb = corpus
    eng = tlc.SegmentedEngine(docs[:128], emb, device="cpu")
    eng.append(docs[128:160])
    idx = ClusterIndex(eng, num_cells=5, top_p=2, seed=1)
    eng.delete([3, 40, 41, 150])
    eng.compact()
    idx.rebuild()
    fresh = ClusterIndex(eng, num_cells=5, top_p=2, seed=1)
    np.testing.assert_array_equal(idx.labels, fresh.labels)
    assert_bit_equal(idx.routed_topk(docs[:8], K), fresh.routed_topk(docs[:8], K))
    assert not np.isin(_np(idx.routed_topk(docs[:8], K).indices),
                       [3, 40, 41, 150]).any()


def test_misuse_raises(corpus):
    _, docs, emb = corpus
    mono = tlc.LCRWMDEngine(docs[:64], emb, device="cpu")
    with pytest.raises(TypeError):
        ClusterIndex(mono, num_cells=4)
    eng = tlc.SegmentedEngine(docs[:64], emb, device="cpu")
    with pytest.raises(ValueError):
        ClusterIndex(eng, num_cells=0)
    with pytest.raises(ValueError):
        ClusterIndex(eng, num_cells=65)
    idx = ClusterIndex(eng, num_cells=4, seed=0)
    with pytest.raises(ValueError):
        td.build_serve_step(engine=mono, index=idx, k=K)
    with pytest.raises(ValueError):
        td.build_serve_step(engine=eng, index=idx, k=K, streaming=False)


@pytest.mark.parametrize("kw", [dict(num_cells=0), dict(num_cells=4, top_p=0),
                                dict(num_cells=4, bound_slack=-1.0),
                                dict(num_cells=4, method="voronoi")])
def test_index_config_validation(kw):
    with pytest.raises(ValueError):
        IndexConfig(**kw)


def test_footprint_no_corpus_sized_gather(corpus, monkeypatch):
    """Building, routing, add and the routed top-k and serve step, under an
    op-shape trace with every chunk smaller than the corpus."""
    from repro_torch.core import wcd as twcd
    from repro_torch.kernels import rwmd_pairwise as trw
    from repro_torch.workloads import clustering as tc

    _, docs, emb = corpus
    monkeypatch.setattr(tc, "_ROWS", 32)
    monkeypatch.setattr(trw, "_PLAIN_DOCS", 32)
    monkeypatch.setattr(twcd, "_CENTROID_ROWS", 32)
    with _Shapes() as rec:
        eng = tlc.SegmentedEngine(docs[:150], emb, device="cpu", row_block=32)
        idx = ClusterIndex(eng, num_cells=N_CELLS, top_p=2, seed=0)
        idx.add(eng.append(docs[150:160]), docs[150:160])
        idx.routed_topk(docs[:8], K)
        td.build_serve_step(engine=eng, index=idx, **SERVE_KW)(docs[:8])
        ClusterIndex(eng, num_cells=4, seed=0, method="kmedoids")
    assert len(rec.shapes) > 100
    assert_no_corpus_sized_gather(rec.shapes, 160, docs.h_max, emb.shape[1],
                                  N_CELLS)
