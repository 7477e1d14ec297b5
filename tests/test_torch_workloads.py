"""The port's corpus workloads against the reference's, on the CPU.

Both packages see ``conftest.py``'s ``small_corpus`` (96 docs, vocab 512,
m 48), carried across by ``repro_torch.convert.from_numpy``.  The port runs
``device="cpu"`` (each kernel's plain version), the reference its jnp
engines.

Ids must be the reference's exactly where the distances are apart; a
distance may differ by the gram form's noise (ROADMAP C): within 1e-4
relative and 1e-2 absolute, as ``tests/test_workloads.py`` holds the
reference to its brute force.  Where two neighbours are closer than 1e-2,
their order may differ (the reference's own brute-force test of the
cross-corpus top-k fails on 2 of 384 such ids), so ids are compared only
where the reference's neighbouring gaps exceed 1e-2.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import lc_rwmd as jlc
from repro.data.docs import DocSet as JDocSet
from repro.workloads import corpus_distance as jcd
from repro.workloads import neighbors as jnb
from repro_torch import workloads as tw
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.data.docs import DocSet
from repro_torch.workloads import corpus_distance as tcd
from repro_torch.workloads import neighbors as tnb

RTOL, ATOL = 1e-4, 1e-2
ATOL_ZERO = 2.5e-2   # the gram form's noise on a zero distance (ROADMAP C)
# docs 5 ≡ 50 ≡ 77 and 7 ≡ 90 (tests/test_workloads.py's planted copies)
PLANTED = ((5, 50), (77, 50), (7, 90))
DEAD = (3, 50, 71)   # the segmented engines' deleted docs


def _ported(ids, w, emb):
    return from_numpy(np.asarray(ids), np.asarray(w), emb, device="cpu")


@pytest.fixture(scope="module")
def engines(small_corpus):
    c = small_corpus
    docs, emb = _ported(c.docs.ids, c.docs.weights, c.emb)
    return (jlc.LCRWMDEngine(c.docs, jnp.asarray(c.emb)),
            tlc.LCRWMDEngine(docs, emb, device="cpu"))


@pytest.fixture(scope="module")
def dup_engines(small_corpus):
    ids = np.array(small_corpus.docs.ids)
    w = np.array(small_corpus.docs.weights)
    for dst, src in PLANTED:
        ids[dst], w[dst] = ids[src], w[src]
    docs, emb = _ported(ids, w, small_corpus.emb)
    return (jlc.LCRWMDEngine(JDocSet(ids=jnp.asarray(ids),
                                     weights=jnp.asarray(w)),
                             jnp.asarray(small_corpus.emb)),
            tlc.LCRWMDEngine(docs, emb, device="cpu"))


def _assert_topk(got, want, *, gap=ATOL):
    """Distances within RTOL/ATOL; ids equal wherever both of the
    reference's neighbouring gaps exceed ``gap`` (gap=0: every id)."""
    gd, gi = got.dists.numpy(), got.indices.numpy()
    wd, wi = np.asarray(want.dists), np.asarray(want.indices)
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=ATOL)
    apart = np.ones(wd.shape, bool)
    if gap:
        g = np.diff(wd, axis=1) > gap
        apart[:, 1:] &= g
        apart[:, :-1] &= g
    np.testing.assert_array_equal(gi[apart], wi[apart])
    return apart


# ---------------------------------------------------------------------------
# The engines' tile primitives
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def seg_engines(small_corpus):
    """A base of 70 docs plus a 26-doc delta, docs 3, 50 and 71 deleted, in
    both packages."""
    c = small_corpus
    docs, emb = _ported(c.docs.ids, c.docs.weights, c.emb)
    je = jlc.SegmentedEngine(JDocSet(ids=c.docs.ids[:70],
                                     weights=c.docs.weights[:70]),
                             jnp.asarray(c.emb))
    je.append(JDocSet(ids=c.docs.ids[70:], weights=c.docs.weights[70:]))
    te = tlc.SegmentedEngine(docs[:70], emb, device="cpu")
    te.append(docs[70:])
    je.delete(list(DEAD))
    te.delete(list(DEAD))
    return je, te


@pytest.mark.parametrize("kind", ["mono", "segmented"])
def test_phase1_resident_and_one_sided_rows_match_reference(
        engines, seg_engines, kind):
    """Z of a resident tile and the ELL SpMM over rows (one out of range):
    the reference's values within the gram form's noise (a word's distance
    to itself, 0, comes out up to ~2.5e-2 in either package); a segmented
    engine's rows each from the segment that owns them, deleted rows
    included.  The tile's padding ids (-1, 200) and deleted docs are empty
    histograms: their Z columns are phase 1's "none" (sqrt(3.4e38), as the
    reference's kernels give; its jnp path gives +inf) and are left out of
    the comparison."""
    je, te = engines if kind == "mono" else seg_engines
    idx = np.array([0, 3, 17, 69, 70, 71, 95, -1, 200], np.int32)
    rows = np.array([1, 3, 68, 69, 70, 71, 72, 94, 96], np.int32)
    real = (idx >= 0) & (idx < 96) & ~np.isin(
        idx, DEAD if kind == "segmented" else [])
    jz = je.phase1_resident(jnp.asarray(idx))
    tz = te.phase1_resident(idx)
    for a, b in zip(jz if kind == "segmented" else (jz,),
                    tz if kind == "segmented" else (tz,)):
        b = b.numpy()
        np.testing.assert_allclose(b[:, real], np.asarray(a)[:, real],
                                   rtol=RTOL, atol=ATOL_ZERO)
        assert (b[:, ~real] > 1e19).all()
    got = te.one_sided_rows(rows, tz).numpy()
    want = np.asarray(je.one_sided_rows(jnp.asarray(rows), jz))
    np.testing.assert_allclose(got[:, real], want[:, real], rtol=RTOL,
                               atol=ATOL_ZERO)
    assert not got[-1].any()                     # row 96: out of range


def test_slice_rows_clips_at_the_end(small_corpus):
    docs, _ = _ported(small_corpus.docs.ids, small_corpus.docs.weights,
                      small_corpus.emb)
    assert torch.equal(docs.slice_rows(10, 20).ids, docs.ids[10:30])
    tail = docs.slice_rows(90, 20)
    assert tail.n_docs == 6 and torch.equal(tail.weights, docs.weights[90:])


# ---------------------------------------------------------------------------
# Self all-pairs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tile", [16, 20, 96])   # divisible, ragged, single
def test_self_topk_matches_reference(engines, tile):
    je, te = engines
    got = tcd.corpus_self_topk(te, 5, tile=tile)
    want = jcd.corpus_self_topk(je, 5, tile=tile)
    _assert_topk(got, want, gap=0)
    assert not (got.indices.numpy() == np.arange(96)[:, None]).any()


def test_scheduler_visits_upper_pairs_in_the_reference_order(engines):
    je, te = engines
    got = [(b.s, b.t, b.mirrored, tuple(b.block.shape))
           for b in tcd.SelfPairScheduler(te, tile=40).blocks()]
    want = [(b.s, b.t, b.mirrored) for b in
            jcd.SelfPairScheduler(je, tile=40).blocks()]
    assert [g[:3] for g in got] == want == [
        (0, 0, False), (0, 1, True), (1, 1, False), (0, 2, True),
        (1, 2, True), (2, 2, False)]
    # the last tile at its real size: 96 = 40 + 40 + 16
    assert [g[3] for g in got] == [(40, 40), (40, 40), (40, 40), (40, 16),
                                   (40, 16), (16, 16)]


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


def test_block_step_is_tile_bounded(engines):
    """The port's footprint probe (the reference's ``test_step_is_tile_
    bounded`` needs a jax API this container lacks): one block step's ops
    make (tile, tile) blocks and nothing of n·n elements; the largest is
    the plain SpMM's (tile, h, tile) gather or a (v_e, tile) Z."""
    _, te = engines
    n, h, tile = te.resident.n_docs, te.resident.h_max, 16
    sched = tcd.SelfPairScheduler(te, tile=tile)
    z = sched._z_tile(0)
    idx = sched._tile_idx(0)
    with _Shapes() as rec:
        sched._step(z, z, idx, idx)
    assert (tile, tile) in rec.shapes
    assert all(int(np.prod(s)) < n * n for s in rec.shapes)
    v_e = te.emb_restricted.shape[0]
    assert max(int(np.prod(s)) for s in rec.shapes) <= max(
        tile * h * tile, v_e * tile)


# ---------------------------------------------------------------------------
# Cross-corpus and the serve-step all-pairs
# ---------------------------------------------------------------------------
def test_cross_corpus_topk_both_sides(small_corpus, engines):
    je, te = engines
    c = small_corpus
    q, _ = _ported(c.docs.ids[60:83], c.docs.weights[60:83], c.emb)
    got = tcd.corpus_vs_corpus_topk(te, q, 4, tile=8, resident_side=True)
    want = jcd.corpus_vs_corpus_topk(
        je, JDocSet(ids=c.docs.ids[60:83], weights=c.docs.weights[60:83]), 4,
        tile=8, resident_side=True)
    assert got.query_topk.indices.shape == (23, 4)
    _assert_topk(got.query_topk, want.query_topk)
    apart = _assert_topk(got.resident_topk, want.resident_topk)
    assert apart.mean() > 0.9


def test_self_topk_distributed_matches_reference(small_corpus, engines):
    from repro.launch.mesh import make_host_mesh

    je, te = engines
    got = tcd.corpus_self_topk_distributed(te, None, 4, tile=40, refine=True)
    want = jcd.corpus_self_topk_distributed(
        je, make_host_mesh(data=1, model=1), 4, tile=40, refine=True)
    _assert_topk(got, want)
    assert not (got.indices.numpy() == np.arange(96)[:, None]).any()
    # a segmented engine runs the segmented step's mesh program on a mesh:
    # on a mesh of one it is the mesh-less run bit for bit
    from repro_torch.launch.mesh import make_host_mesh as tmesh

    seg = tlc.SegmentedEngine(te.resident, te.emb_full, device="cpu")
    on_mesh = tcd.corpus_self_topk_distributed(seg, tmesh(device="cpu"), 4,
                                               tile=48, refine=False)
    alone = tcd.corpus_self_topk_distributed(seg, None, 4, tile=48,
                                             refine=False)
    assert torch.equal(on_mesh.dists, alone.dists)
    assert torch.equal(on_mesh.indices, alone.indices)
    assert not (on_mesh.indices.numpy() == np.arange(96)[:, None]).any()


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------
def _assert_graph(got, want):
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.data, want.data, rtol=RTOL, atol=ATOL)
    assert got.n_docs == want.n_docs and got.n_edges == want.n_edges


@pytest.mark.parametrize("tile", [40, 64])
def test_near_duplicate_graph_matches_reference(dup_engines, tile):
    je, te = dup_engines
    got = tnb.near_duplicate_graph(te, 0.05, tile=tile)
    _assert_graph(got, jnb.near_duplicate_graph(je, 0.05, tile=tile))
    groups = [sorted(g.tolist()) for g in tnb.duplicate_groups(got)]
    assert [5, 50, 77] in groups and [7, 90] in groups
    for i in range(got.n_docs):
        assert i not in got.indices[got.indptr[i]:got.indptr[i + 1]]


def test_components_and_groups_match_reference(dup_engines):
    """On the reference's mutual 1-NN graph (many small components)."""
    je, _ = dup_engines
    want = jnb.knn_graph(je, 1, tile=32, mutual=True)
    got = tnb.NeighborGraph(want.indptr, want.indices, want.data,
                            want.n_docs)
    np.testing.assert_array_equal(tnb.connected_components(got),
                                  jnb.connected_components(want))
    tg, jg = tnb.duplicate_groups(got), jnb.duplicate_groups(want)
    assert len(tg) == len(jg) > 2
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mutual", [False, True])
def test_knn_graph_matches_reference(engines, mutual):
    je, te = engines
    got = tnb.knn_graph(te, 3, tile=32, mutual=mutual)
    _assert_graph(got, jnb.knn_graph(je, 3, tile=32, mutual=mutual))
    if mutual:
        union = tnb.knn_graph(te, 3, tile=32)
        ue = {(i, int(j)) for i in range(96)
              for j in union.indices[union.indptr[i]:union.indptr[i + 1]]}
        assert all((i, int(j)) in ue for i in range(96)
                   for j in got.indices[got.indptr[i]:got.indptr[i + 1]])


def test_near_duplicate_threshold_floor_warns_and_clamps(dup_engines):
    _, te = dup_engines
    with pytest.warns(UserWarning, match="noise floor"):
        g = tnb.near_duplicate_graph(te, tnb.DUPLICATE_SCORE_FLOOR / 100,
                                     tile=40)
    groups = [sorted(gr.tolist()) for gr in tnb.duplicate_groups(g)]
    assert [5, 50, 77] in groups and [7, 90] in groups


# ---------------------------------------------------------------------------
# Segmented engines
# ---------------------------------------------------------------------------
def test_segmented_workloads_match_reference(seg_engines):
    """The self top-k against the reference's SegmentedEngine (deleted
    rows all unfilled, no deleted neighbour); the cross-corpus top-k leaves
    the deleted docs out of both sides."""
    je, te = seg_engines
    got = tcd.corpus_self_topk(te, 4, tile=48)
    want = jcd.corpus_self_topk(je, 4, tile=48)
    _assert_topk(got, want, gap=0)
    dead = list(DEAD)
    assert (got.indices[dead] == -1).all()
    assert not np.isin(got.indices.numpy(), dead).any()
    res = te.resident
    q = DocSet(ids=res.ids[10:30], weights=res.weights[10:30])
    gq = tcd.corpus_vs_corpus_topk(te, q, 3, tile=10, resident_side=True)
    assert not np.isin(gq.query_topk.indices.numpy(), dead).any()
    assert (gq.resident_topk.indices[dead] == -1).all()
    live = np.setdiff1d(np.arange(96), dead)
    assert (gq.resident_topk.indices[live] >= 0).all()


def test_exports_are_the_references():
    from repro import workloads as jw

    assert sorted(jw.__all__) == tw.__all__
    for name in tw.__all__:
        assert getattr(tw, name) is not None
