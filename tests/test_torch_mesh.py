"""The port's mesh program (``repro_torch.launch.mesh``, the cross-rank
top-k, the serve step and all-pairs D1 under a mesh) against the
reference, on the CPU.

In process, on a mesh of one rank (no process group): each step equals the
port's mesh-less step bit for bit, and the reference's step on
``make_host_mesh(1, 1)`` within ``test_torch_engine``'s tolerances (2.5e-2
absolute, the gram form's noise; 1e-4 relative; ids exact where the
neighbouring gaps exceed that).

On eight ranks: ``tests/torch_mesh_ranks.rank_main`` is spawned as 8
gloo ranks (``torch.multiprocessing``; a file rendezvous under the test's
temporary directory, one thread each) over the meshes of
``tests/dist_check.py``:
(4, 2), (2, 2, 2), (1, 8) and (8, 1), each with ``phase1_full_mesh`` False
and True.  The spawn runs once and every eight-rank test reads its files.
The ranks' results are held against the reference's single-device
``lc_rwmd_one_sided`` and ``topk_smallest`` and its engine step, computed
here, within ``dist_check.py``'s tolerance (1e-4 relative, 1e-2 absolute;
ids by the distance they name, as there).  The spawn also serves the
segmented and routed steps over a three-segment engine with tombstones and
a 16-cell index, self-excluding, through a delete, an append and a
compact (``torch_mesh_ranks.VERSIONS``); the reference's single-device
steps after the same changes, and its ``QueryServer`` on the same stream
with the same lapsed deadline, are computed here while the ranks run.  So
is the reference's ``AsyncQueryServer`` on the raw payloads and corpus
changes that the ranks' ``AsyncQueryServer`` serves through an ingest pool
(``torch_mesh_ranks.async_stream``).
"""

import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import lc_rwmd as jlc
from repro.core import lc_rwmd_one_sided, topk_smallest
from repro.data.docs import DocSet as JDocSet
from repro.data.synth import CorpusSpec, make_corpus
from repro.distributed import lcrwmd_dist as jd
from repro.index import ClusterIndex as JIndex
from repro.launch.mesh import make_host_mesh as jmesh
from repro.serving import query_server as jqs
from _ingest_vectorizers import SeededHistogramVectorizer
from repro_torch.convert import from_numpy
from repro_torch.core import lc_rwmd as tlc
from repro_torch.core import topk as ttk
from repro_torch.distributed import lcrwmd_dist as td
from repro_torch.index import ClusterIndex
from repro_torch.launch import mesh as tmesh
from repro_torch.serving import query_server as tqs
from repro_torch.workloads import corpus_distance as tcd
import torch_mesh_ranks
from torch_mesh_ranks import (APPEND, ASYNC_BASE, ASYNC_BATCH,
                              ASYNC_DEAD, ASYNC_LAPSED, ASYNC_ODD, ASYNC_PART,
                              ASYNC_REJECTED, ASYNC_STATS, CELLS, DEAD,
                              LAPSE_S, LAPSED, RECOVER_AFTER, ROUTED_RUNS,
                              SEG_RUNS, SEGMENTS, SERVER_BATCH, SERVER_PICKS,
                              VERSIONS, async_config, async_stream)
from test_torch_engine import _np, assert_topk_close
from test_torch_segments import RERANK_KW

K = 6
B = 8
# few Sinkhorn iterations: tier 0 is held to the mesh-less step bit for bit
RERANK = dict(refine=True, rerank_wmd=True, rerank_budget=2 * K,
              wmd_kw=dict(RERANK_KW, max_iters=5))


@pytest.fixture(scope="module")
def small(small_corpus):
    docs, emb = from_numpy(np.asarray(small_corpus.docs.ids),
                           np.asarray(small_corpus.docs.weights),
                           small_corpus.emb, device="cpu")
    return small_corpus, docs, emb


@pytest.fixture(scope="module")
def jeng(small_corpus):
    return jlc.LCRWMDEngine(small_corpus.docs, small_corpus.emb, row_block=32)


@pytest.fixture(scope="module")
def one():
    return tmesh.make_host_mesh(device="cpu")


def _equal(a, b):
    assert torch.equal(a.topk.dists, b.topk.dists)
    assert torch.equal(a.topk.indices, b.topk.indices)
    for x, y in ((a.d_local, b.d_local), (a.pruned_exact, b.pruned_exact)):
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y)


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
def test_mesh_of_one_needs_no_process_group(one):
    assert not torch.distributed.is_initialized()
    assert tmesh.mesh_axis_names(one) == ("data", "model")
    assert tmesh.batch_axes(one) == ("data",) and tmesh.n_chips(one) == 1
    three = tmesh.make_host_mesh(1, 1, 1, device="cpu")
    assert three.axis_names == ("pod", "data", "model")
    assert tmesh.batch_axes(three) == ("pod", "data")
    assert three.coords == {"pod": 0, "data": 0, "model": 0}
    x = torch.arange(6.0).reshape(2, 3)
    assert one.psum(x, ("data", "model")) is x
    assert one.all_gather(x, ("data",), dim=1) is x
    assert sum(one.counts.values()) == 0
    assert td.local_rows(one, 96) == (0, 96)


def test_mesh_must_be_the_world():
    for shape in ((2, 1), (1, 2), (1, 1, 2)):
        with pytest.raises(ValueError, match="> 1 ranks"):
            tmesh.make_host_mesh(*shape, device="cpu")
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="ranks"):
            tmesh.make_production_mesh(multi_pod=multi_pod)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()


@pytest.mark.parametrize("n_local", [3, 10])
def test_distributed_topk_on_one_rank(one, n_local):
    """The local top-k, its ids moved by the offset, and a partial shorter
    than k padded with unfilled slots that rank last."""
    g = torch.Generator().manual_seed(n_local)
    d = torch.rand(n_local, 4, generator=g)
    got = ttk.distributed_topk(d, 5, mesh=one, axis_names=("data",),
                               shard_offset=40)
    want = ttk.topk_smallest(d.T, min(5, n_local))
    assert got.dists.shape == (4, 5)
    assert torch.equal(got.dists[:, :want.dists.shape[1]], want.dists)
    assert torch.equal(got.indices[:, :want.dists.shape[1]], want.indices + 40)
    assert (got.indices[:, n_local:] == -1).all()
    assert torch.isinf(got.dists[:, n_local:]).all()


# ---------------------------------------------------------------------------
# A mesh of one: bit for bit the mesh-less step, close to the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("refine", [False, True])
def test_engineless_step_on_a_mesh_of_one(one, small, refine):
    c, docs, emb = small
    kw = dict(k=7, refine=refine, bf16_matmul=False)
    got = td.build_serve_step(one, **kw)(docs, docs[:5], emb)
    _equal(got, td.build_serve_step(device="cpu", **kw)(docs, docs[:5], emb))
    want = jd.build_serve_step(jmesh(1, 1), **kw)(c.docs, c.docs[:5],
                                                  jnp.asarray(c.emb))
    np.testing.assert_allclose(_np(got.d_local), _np(want.d_local),
                               rtol=1e-4, atol=2.5e-2)
    assert_topk_close(got.topk, want.topk)


@pytest.mark.parametrize("full_mesh", [False, True])
def test_allpairs_d1_on_a_mesh_of_one(one, small, full_mesh):
    c, docs, emb = small
    got = td.build_allpairs_d1(one, bf16_matmul=False,
                               phase1_full_mesh=full_mesh)(docs, docs[:4], emb)
    assert torch.equal(got, td.build_allpairs_d1(bf16_matmul=False,
                                                 device="cpu")(docs, docs[:4],
                                                               emb))
    want = jd.build_allpairs_d1(jmesh(1, 1), bf16_matmul=False,
                                phase1_full_mesh=full_mesh)(
        c.docs, c.docs[:4], jnp.asarray(c.emb))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=2.5e-2)


def test_refine_only_tightens_on_a_mesh(one, small):
    _, docs, emb = small
    queries = docs[8:12]
    base = td.build_serve_step(one, k=6, bf16_matmul=False)(docs, queries, emb)
    ref = td.build_serve_step(one, k=6, refine=True, bf16_matmul=False)(
        docs, queries, emb)
    for j in range(4):
        d1 = dict(zip(base.topk.indices[j].tolist(),
                      base.topk.dists[j].tolist()))
        for i, d in zip(ref.topk.indices[j].tolist(),
                        ref.topk.dists[j].tolist()):
            assert d >= d1[i]


@pytest.mark.parametrize("streaming, tier",
                         [(True, 0), (True, 1), (True, 2), (False, 1)])
def test_monolithic_step_on_a_mesh_of_one(one, small, jeng, streaming, tier):
    """Self-excluding, with the refine and the rerank configured: the mesh
    step is the mesh-less step bit for bit at every tier, and tiers 1 and 2
    match the reference's.  (Tier 2 never reads ``streaming``; tier 0 runs
    tier 1's candidates through the same replicated refine and rerank.)"""
    c, docs, emb = small
    ids = torch.arange(B, dtype=torch.int32)
    eng = tlc.LCRWMDEngine(docs, emb, device="cpu", row_block=32)
    kw = dict(k=K, bf16_matmul=False, self_exclude=True, streaming=streaming,
              row_block=32, **RERANK)
    got = td.build_serve_step(one, engine=eng, **kw)(docs[:B], ids, tier=tier)
    _equal(got, td.build_serve_step(engine=eng, **kw)(docs[:B], ids,
                                                      tier=tier))
    assert got.tier == tier and not (got.topk.indices == ids[:, None]).any()
    if tier:
        want = jd.build_serve_step(jmesh(1, 1), engine=jeng, **kw)(
            c.docs[:B], query_ids=jnp.arange(B), tier=tier)
        assert_topk_close(got.topk, want.topk)


def test_corpus_self_topk_distributed_on_a_mesh_of_one(one, small):
    """Bit for bit the mesh-less run, which
    ``test_torch_workloads.test_self_topk_distributed_matches_reference``
    holds against the reference's run on ``make_host_mesh(1, 1)``."""
    _, docs, emb = small
    eng = tlc.LCRWMDEngine(docs, emb, device="cpu")
    got = tcd.corpus_self_topk_distributed(eng, one, 4, tile=48)
    same = tcd.corpus_self_topk_distributed(eng, None, 4, tile=48)
    assert torch.equal(got.dists, same.dists)
    assert torch.equal(got.indices, same.indices)
    assert not (got.indices == torch.arange(96)[:, None]).any()


SEG_DEAD = [2, 65, 90]
SEG_CUTS = ((0, 60), (60, 80), (80, 96))


def _segmented(docs, emb):
    """Three segments, then tombstones (query 2's own doc among them)."""
    eng = tlc.SegmentedEngine(docs[slice(*SEG_CUTS[0])], emb, device="cpu",
                              row_block=32)
    for lo, hi in SEG_CUTS[1:]:
        eng.append(docs[lo:hi])
    eng.delete(SEG_DEAD)
    return eng


def test_segmented_step_on_a_mesh_of_one_is_the_one_device_step(one, small):
    """Self-excluding over three segments with tombstones, the refine and
    the rerank configured: bit for bit the mesh-less step at every tier,
    and the same callable at tier 1 across a delete and a compact."""
    _, docs, emb = small
    seg = _segmented(docs, emb)
    ids = torch.arange(B, dtype=torch.int32)
    kw = dict(k=K, bf16_matmul=False, self_exclude=True, row_block=32,
              **RERANK)
    mesh_step = td.build_serve_step(one, engine=seg, **kw)
    flat = td.build_serve_step(engine=seg, **kw)
    for change in (None, "delete", "compact"):
        if change == "delete":
            seg.delete([7, 70])
        elif change == "compact":
            seg.compact()
        for tier in (1,) if change else (0, 1, 2):
            got = mesh_step(docs[:B], ids, tier=tier)
            _equal(got, flat(docs[:B], ids, tier=tier))
            i = _np(got.topk.indices)
            assert not (i == np.arange(B)[:, None]).any()
            assert not np.isin(i, SEG_DEAD).any()


SERVE_KW = dict(k=K, max_batch=6, h_max=16)
SERVE_PICKS = (3, 50, 17, 88, 2, 61, 40, 9, 72, 33, 5, 94, 21)


def _served(server, stream):
    for q in stream:
        server.submit(*q)
    return server.flush()


def test_servers_on_a_mesh_device_and_rank_count(one, small):
    """A ``cfg.device`` that is not the mesh's raises; on a mesh of one rank
    the async server is its own leader and makes corpus changes on the
    caller's thread (over more ranks the eight-rank spawn serves it, see
    ``test_eight_ranks_async_server``), and its answers are the sync
    server's."""
    _, docs, emb = small
    with pytest.raises(ValueError, match="mesh's"):
        tqs.QueryServer(docs, emb, tqs.ServerConfig(device="meta"), mesh=one)
    with pytest.raises(ValueError, match="mesh's"):
        tqs.AsyncQueryServer(docs, emb, tqs.ServerConfig(device="meta"),
                             mesh=one)
    ids, w = docs.ids.numpy(), docs.weights.numpy()
    cfg = tqs.ServerConfig(device="cpu", **SERVE_KW)
    with tqs.AsyncQueryServer(docs, emb, cfg, mesh=one) as srv:
        assert srv._ranks == 1 and srv._lead
        futures = [srv.submit(ids[p], w[p]) for p in SERVE_PICKS[:6]]
        got = [f.result(timeout=120) for f in futures]
        srv.delete_docs([95])
        assert not srv._changes and not srv.engine.live_mask()[95]
    want = _served(tqs.QueryServer(docs, emb, cfg),
                   [(ids[p], w[p]) for p in SERVE_PICKS[:6]])
    for a, b in zip(got, want):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_async_server_on_a_mesh_of_one_is_the_meshless_one(one, small):
    """Raw payloads vectorized in the worker, an ingest and a delete
    between parts: on a mesh of one rank the async server's answers,
    tiers and stats are the mesh-less async server's bit for bit."""
    _, docs, emb = small
    vec = SeededHistogramVectorizer(vocab=emb.shape[0], h_max=docs.h_max)
    cfg = tqs.ServerConfig(device="cpu", **SERVE_KW)

    def serve(mesh):
        with tqs.AsyncQueryServer(docs[:80], emb, cfg, mesh=mesh,
                                  preprocess=vec) as srv:
            first = [srv.submit(7 + j) for j in range(8)]
            srv.drain()
            srv.ingest(docs[80:])
            srv.delete_docs([3, 85])
            rest = [srv.submit(7 + j) for j in range(8)]
            srv.drain()
            stats = srv.stats_snapshot()
        return [f.result(timeout=120) for f in first + rest], stats

    (got, got_stats), (want, want_stats) = serve(one), serve(None)
    for a, b in zip(got, want):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a.tier == b.tier == 0
    assert not np.isin(np.stack([a[0] for a in got[8:]]), [3, 85]).any()
    for key in ("queries", "tier_counts", "deadline_misses"):
        assert got_stats[key] == want_stats[key]


def test_mesh_device_must_be_the_engines(one, small):
    _, docs, emb = small
    eng = tlc.LCRWMDEngine(docs, emb, device="cpu")
    meta = types.SimpleNamespace(size=1, device=torch.device("meta"))
    with pytest.raises(ValueError, match="mesh's device"):
        td.build_serve_step(meta, k=3, engine=eng)
    with pytest.raises(ValueError, match="mesh's"):
        td.build_serve_step(one, k=3, device="meta")
    with pytest.raises(ValueError, match="mesh's"):
        td.build_allpairs_d1(one, device="meta")


# ---------------------------------------------------------------------------
# Eight gloo ranks, one spawn
# ---------------------------------------------------------------------------
MESHES = {"d4m2": (4, 2, None), "p2d2m2": (2, 2, 2), "d1m8": (1, 8, None),
          "d8m1": (8, 1, None)}
N, QB, KK, ROW_BLOCK = 64, 6, 5, 4
RTOL, ATOL = 1e-4, 1e-2          # tests/dist_check.py's
_RUN: dict = {}


def _ranks(tmp_path_factory) -> dict:
    """Spawn the 8 ranks once (inputs written here, from the reference's
    corpus generator); returns the corpus, the references and each rank's
    results."""
    if _RUN:
        return _RUN
    corpus = make_corpus(CorpusSpec(n_docs=N, vocab_size=512, emb_dim=32,
                                    h_max=8, mean_h=5.0, seed=3))
    ds, emb = corpus.docs, jnp.asarray(corpus.emb)
    out = tmp_path_factory.mktemp("mesh_ranks")
    inputs = out / "inputs.npz"
    np.savez(inputs, ids=np.asarray(ds.ids), weights=np.asarray(ds.weights),
             emb=np.asarray(corpus.emb), b=QB, k=KK, row_block=ROW_BLOCK)
    ctx = mp.spawn(torch_mesh_ranks.rank_main, args=(str(inputs), str(out)),
                   nprocs=torch_mesh_ranks.WORLD, join=False)
    try:
        # the references, while the ranks run
        d_ref = np.asarray(lc_rwmd_one_sided(ds, ds[:QB], emb))      # (n, B)
        jeng = jlc.LCRWMDEngine(ds, corpus.emb, row_block=ROW_BLOCK)
        mono_ref = jd.build_serve_step(
            jmesh(1, 1), k=KK, bf16_matmul=False, engine=jeng,
            self_exclude=True, row_block=ROW_BLOCK)(
                ds[:QB], query_ids=jnp.arange(QB))
        life_ref = _reference_lifecycle(ds, corpus.emb)
        server_ref = _reference_server(ds, corpus.emb)
        async_ref = _reference_async(ds, corpus.emb)
        deadline = time.monotonic() + 270
        while not ctx.join(timeout=1):      # raises if a rank failed
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [dict(np.load(out / f"rank{i}.npz")) for i in range(8)]
    _RUN.update(ranks=ranks, d_ref=d_ref, mono_ref=mono_ref,
                life_ref=life_ref, server_ref=server_ref,
                async_ref=async_ref, inputs=inputs)
    return _RUN


def _reference_lifecycle(ds, emb) -> dict:
    """The reference's single-device segmented and routed steps over the
    ranks' engine and index, after the same changes, at every version
    (the routed step before the append), with each version's route and
    live mask."""
    cut = lambda lo, hi: JDocSet(ids=ds.ids[lo:hi],       # noqa: E731
                                 weights=ds.weights[lo:hi])
    eng = jlc.SegmentedEngine(cut(*SEGMENTS[0]), emb)
    for lo, hi in SEGMENTS[1:]:
        eng.append(cut(lo, hi))
    idx = JIndex(eng, **CELLS)
    eng.delete(list(DEAD[0]))
    kw = dict(k=KK, bf16_matmul=False, self_exclude=True, streaming=True,
              row_block=ROW_BLOCK)
    steps = {"seg": jd.build_serve_step(jmesh(1, 1), engine=eng, **kw),
             "routed": jd.build_serve_step(jmesh(1, 1), engine=eng,
                                           index=idx, **kw)}
    out = {}
    for ver in VERSIONS:
        if ver == "delete":
            eng.delete(list(DEAD[1]))
        elif ver == "append":
            # the routed step is held to the reference until here; after
            # it, to the port's one-device routed step (tested against the
            # reference's in test_torch_index), which spares the
            # reference's index.add, rebuild and new traces
            eng.append(cut(*APPEND))
            steps.pop("routed")
        elif ver == "compact":
            eng.compact()
        for tag, step in steps.items():
            tk = step(ds[:QB], query_ids=jnp.arange(QB)).topk
            out[f"{tag}/{ver}"] = (np.asarray(tk.dists),
                                   np.asarray(tk.indices))
            if tag == "routed":
                route = idx.route(ds[:QB])
                out[f"route/{ver}"] = (np.asarray(route.cells),
                                       np.asarray(route.keep))
        out[f"live/{ver}"] = np.asarray(eng.live_mask())
    return out


def _reference_server(ds, emb) -> list:
    """The reference's QueryServer on the ranks' stream, its deadline
    ``LAPSED`` let lapse."""
    server = jqs.QueryServer(ds, emb, jmesh(), jqs.ServerConfig(
        k=KK, max_batch=SERVER_BATCH, h_max=ds.h_max, degradation=True,
        recover_after=RECOVER_AFTER))
    ids, w = np.asarray(ds.ids), np.asarray(ds.weights)
    for j, pick in enumerate(SERVER_PICKS):
        server.submit(ids[pick], w[pick],
                      deadline=LAPSE_S if j == LAPSED else None)
    time.sleep(20 * LAPSE_S)
    return server.flush()


def _reference_async(ds, emb) -> list:
    """The reference's AsyncQueryServer (in-thread vectorizing, no deadline
    and no fault) on the ranks' payloads, the ingest and the delete made
    between parts B and C."""
    cut = JDocSet(ids=ds.ids[:ASYNC_BASE], weights=ds.weights[:ASYNC_BASE])
    cfg = jqs.ServerConfig(**async_config(ds, k=KK))
    vec = SeededHistogramVectorizer(vocab=emb.shape[0], h_max=ds.h_max)
    futures = []
    with jqs.AsyncQueryServer(cut, emb, jmesh(), cfg, preprocess=vec) as srv:
        for p, part in enumerate(async_stream()):
            if p == 2:
                srv.ingest(JDocSet(ids=ds.ids[ASYNC_BASE:],
                                   weights=ds.weights[ASYNC_BASE:]))
                srv.delete_docs(list(ASYNC_DEAD))
            futures += [srv.submit(x) for x, _ in part]
            srv.drain()
    return [f.result() for f in futures]


def _check_topk(dists, idx, d_ref, want_dists, what):
    """Distances within tolerance of the reference's; each id names a doc
    at (within tolerance) the distance of its slot."""
    np.testing.assert_allclose(dists, want_dists, rtol=RTOL, atol=ATOL,
                               err_msg=what)
    for j in range(idx.shape[0]):
        np.testing.assert_allclose(d_ref[idx[j], j], want_dists[j],
                                   rtol=RTOL, atol=ATOL, err_msg=what)


def _self_masked(d_ref):
    d = d_ref.copy()
    d[np.arange(QB), np.arange(QB)] = np.inf
    return d


def _blocks_cover(run, name, key, want):
    """Every rank's row block of ``key`` matches ``want``'s rows, and the
    blocks of one model column cover all rows."""
    seen = np.zeros(N, bool)
    for r in run["ranks"]:
        lo, hi = r[f"{name}/rows"]
        np.testing.assert_allclose(r[key], want[lo:hi], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
        seen[lo:hi] = True
    assert seen.all()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("full_mesh", [0, 1])
@pytest.mark.parametrize("name", list(MESHES))
def test_eight_ranks_engineless_step(tmp_path_factory, name, full_mesh):
    run = _ranks(tmp_path_factory)
    d_ref = run["d_ref"]
    want = np.asarray(topk_smallest(jnp.asarray(d_ref).T, KK).dists)
    tag = f"{name}/fm{full_mesh}/el"
    r0 = run["ranks"][0]
    _check_topk(r0[f"{tag}/d"], r0[f"{tag}/i"], d_ref, want, tag)
    _blocks_cover(run, name, f"{tag}/d_local", d_ref)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("full_mesh", [0, 1])
@pytest.mark.parametrize("name", list(MESHES))
def test_eight_ranks_allpairs_d1(tmp_path_factory, name, full_mesh):
    run = _ranks(tmp_path_factory)
    _blocks_cover(run, name, f"{name}/fm{full_mesh}/d1", run["d_ref"])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("full_mesh", [0, 1])
@pytest.mark.parametrize("name", ["p2d2m2", "d1m8"])
def test_eight_ranks_monolithic_step(tmp_path_factory, name, full_mesh):
    """Self-excluding: streaming at psum_batch 1 and 8 bit for bit, and the
    materialized step, against the reference engine's step and the
    single-device distances with each query's own row left out."""
    run = _ranks(tmp_path_factory)
    r0 = run["ranks"][0]
    tag = f"{name}/fm{full_mesh}"
    assert np.array_equal(r0[f"{tag}/stream1/d"], r0[f"{tag}/stream8/d"])
    assert np.array_equal(r0[f"{tag}/stream1/i"], r0[f"{tag}/stream8/i"])
    d_self = _self_masked(run["d_ref"])
    want = np.asarray(run["mono_ref"].topk.dists)
    np.testing.assert_allclose(want, np.sort(d_self, axis=0)[:KK].T,
                               rtol=RTOL, atol=ATOL)
    for mode in ("stream1", "dense"):
        _check_topk(r0[f"{tag}/{mode}/d"], r0[f"{tag}/{mode}/i"], d_self,
                    want, f"{tag}/{mode}")
    d_masked = np.where(np.isinf(d_self), 3.4e38, d_self)
    _blocks_cover(run, name, f"{tag}/dense/d_local", d_masked)


@pytest.mark.timeout(300)
def test_eight_ranks_hold_one_topk(tmp_path_factory):
    ranks = _ranks(tmp_path_factory)["ranks"]
    keys = [k for k in ranks[0] if k.endswith(("/d", "/i", "/tier", "/err",
                                               "/cells", "/keep"))
            or k.startswith("async/")]
    steps = len(SEG_RUNS) + len(ROUTED_RUNS) + 2     # and the one-device two
    assert len(keys) == (2 * (8 + 4 * 3) + len(VERSIONS) * (2 * steps + 2) + 8
                         + 7)
    for r in ranks[1:]:
        for key in keys:
            assert np.array_equal(r[key], ranks[0][key]), key


@pytest.mark.timeout(300)
@pytest.mark.parametrize("full_mesh", [0, 1])
@pytest.mark.parametrize("name", ["d1m8", "d8m1"])
def test_eight_ranks_collective_counts(tmp_path_factory, name, full_mesh):
    """``serve_step_collectives_*`` of the monolithic streaming step: one
    psum over model a slab of psum_batch · row_block rows (none where
    model = 1), and one all_gather over each batch axis of size > 1 for
    the top-k, one more for Z under a full mesh."""
    r0 = _ranks(tmp_path_factory)["ranks"][0]
    data, model, _ = MESHES[name]
    n_local = -(-N // data)
    for psb in (1, 8):
        psum = -(-n_local // (ROW_BLOCK * psb)) if model > 1 else 0
        gather = (data > 1) * (1 + full_mesh)
        tag = f"{name}/fm{full_mesh}/count{psb}"
        assert int(r0[f"{tag}/psum"]) == psum
        assert int(r0[f"{tag}/all_gather"]) == gather


@pytest.mark.timeout(300)
def test_eight_ranks_refusals_and_layout(tmp_path_factory):
    ranks = _ranks(tmp_path_factory)["ranks"]
    for r in ranks:
        # the segmented and routed steps and the async server build over
        # 8 ranks
        for name in ("segmented", "routed"):
            assert str(r[f"raise/{name}"]) == "nothing"
        assert str(r["raise/async"]) == "nothing"
        assert str(r["raise/smaller"]).startswith("ValueError")
        assert str(r["raise/larger"]).startswith("ValueError")
    for name, (data, model, pod) in MESHES.items():
        shape = (pod or 1, data, model)
        for rank, r in enumerate(ranks):     # row-major, model fastest
            assert tuple(r[f"{name}/coords"]) == np.unravel_index(rank, shape)
            block = -(-N // (shape[0] * data))
            lo = (rank // model) * block
            assert tuple(r[f"{name}/rows"]) == (lo, min(lo + block, N))


# ---------------------------------------------------------------------------
# Eight ranks: the segmented and routed steps, the server
# ---------------------------------------------------------------------------
STEP_RUNS = ([f"seg/{n}/fm{f}" for n, f in SEG_RUNS]
             + [f"routed/{n}/fm{f}" for n, f in ROUTED_RUNS])


def _version_dists(run, ver):
    """The single-device one-sided distances with the docs outside the
    engine at ``ver``, the dead ones and each query's own doc at +inf."""
    d = _self_masked(run["d_ref"])
    live = run["life_ref"][f"live/{ver}"]
    d[len(live):] = np.inf
    d[:len(live)][~live] = np.inf
    return d


@pytest.mark.timeout(300)
@pytest.mark.parametrize("ver", VERSIONS)
@pytest.mark.parametrize("tag", STEP_RUNS)
def test_eight_ranks_segmented_and_routed_steps(tmp_path_factory, tag, ver):
    """One callable a mesh served across the changes: self-excluding,
    never a dead doc, within tolerance of the reference's single-device
    step (ids by the distance they name), bit for bit the port's
    one-device step where ``model`` = 1 and the vocabulary is not cut
    over the batch axes.  From the append on, the routed step is held to
    the port's one-device routed step (``test_torch_index`` holds that to
    the reference's; after ``compact`` the reference's k-centers may pick
    a dead doc, ROADMAP C, so its cells differ)."""
    run = _ranks(tmp_path_factory)
    r0 = run["ranks"][0]
    variant, name, fm = tag.split("/")
    d, i = r0[f"{tag}/{ver}/d"], r0[f"{tag}/{ver}/i"]
    one_d, one_i = r0[f"{variant}/one/{ver}/d"], r0[f"{variant}/one/{ver}/i"]
    d_ver = _version_dists(run, ver)
    assert np.isfinite(d_ver[i, np.arange(QB)[:, None].repeat(KK, 1)]).all()
    if variant == "routed" and ver in ("append", "compact"):
        want = one_d
    else:
        want = run["life_ref"][f"{variant}/{ver}"][0]
    _check_topk(d, i, d_ver, want, f"{tag}/{ver}")
    if name == "d8m1" and fm == "fm0":
        assert np.array_equal(d, one_d) and np.array_equal(i, one_i)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("ver", VERSIONS)
def test_eight_ranks_route_alike(tmp_path_factory, ver):
    """Every rank routes each version's batch to the same cells (the
    hold-one test compares them); before the append, the reference's."""
    run = _ranks(tmp_path_factory)
    r0 = run["ranks"][0]
    if f"route/{ver}" in run["life_ref"]:
        cells, keep = run["life_ref"][f"route/{ver}"]
        assert np.array_equal(r0[f"route/{ver}/keep"], keep)
        assert np.array_equal(r0[f"route/{ver}/cells"], cells)
    # some rank of a 4- and an 8-way row cut holds no row of a probed cell
    rows = r0[f"route/{ver}/rows"][np.unique(r0[f"route/{ver}/cells"][
        r0[f"route/{ver}/keep"]])]
    assert (rows < 8).any()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("fm", [0, 1])
@pytest.mark.parametrize("name", ["d1m8", "d8m1"])
@pytest.mark.parametrize("variant", ["seg", "routed"])
def test_eight_ranks_seg_and_routed_collective_counts(tmp_path_factory,
                                                      variant, name, fm):
    """``serve_step_collectives_*{variant=seg|routed}`` on rank 0 (after
    the compact): one psum over model a slab of psum_batch · row_block of
    its rows of each segment or probed cell (none where model = 1); one
    all_gather over each batch axis of size > 1 for the top-k and, under
    a full mesh, one more a segment or probed cell for Z."""
    r0 = _ranks(tmp_path_factory)["ranks"][0]
    data, model, _ = MESHES[name]
    if variant == "seg":
        rows = r0["segments/compact"]
    else:
        run = np.unique(r0["route/compact/cells"][r0["route/compact/keep"]])
        rows = r0["route/compact/rows"][run]
    mine = np.minimum(-(-rows // data), rows)       # rank 0's block
    slab = ROW_BLOCK * 8
    psum = int((-(-mine // slab)).sum()) if model > 1 else 0
    gather = (data > 1) * (fm * len(rows) + 1)
    tag = f"gauge/{variant}/{name}/fm{fm}"
    assert int(r0[f"{tag}/psum"]) == psum
    assert int(r0[f"{tag}/all_gather"]) == gather


@pytest.mark.timeout(300)
def test_eight_ranks_query_server(tmp_path_factory):
    """A QueryServer on (8, 1): the deadline that lapsed on rank 0 alone
    lapsed for every rank (the hold-one test compares every rank's
    answers, tiers and errors), the tier stepped down on the miss and back
    up as the reference's did, and the answers are the reference's
    server's; then ``serve_stream`` with rank 0's flushes, every query
    finding itself."""
    run = _ranks(tmp_path_factory)
    r0 = run["ranks"][0]
    _check_server({k[len("server/flush/"):]: v for k, v in r0.items()
                   if k.startswith("server/flush/")}, run["server_ref"])
    assert not any(str(e) for e in r0["server/stream/err"])
    assert (r0["server/stream/i"] == np.array(SERVER_PICKS)[:, None]).any(1).all()


def _check_server(got: dict, want: list):
    """A server's flush (``torch_mesh_ranks._answers`` arrays) against the
    reference server's answers: the lapsed deadline, the tiers, and the
    answers within ``test_torch_engine``'s tolerance."""
    err = [str(e) for e in got["err"]]
    assert err == ["DeadlineExceeded" if j == LAPSED else ""
                   for j in range(len(SERVER_PICKS))]
    assert type(want[LAPSED]).__name__ == "DeadlineExceeded"
    tiers = got["tier"]
    assert [int(t) for t in tiers] == [
        -1 if j == LAPSED else a.tier for j, a in enumerate(want)]
    assert set(tiers) == {-1, 0, 1}
    ok = [j for j in range(len(SERVER_PICKS)) if j != LAPSED]
    assert_topk_close(
        ttk.TopK(torch.as_tensor(got["d"][ok]), torch.as_tensor(got["i"][ok])),
        ttk.TopK(torch.as_tensor(np.stack([want[j][1] for j in ok])),
                 torch.as_tensor(np.stack([want[j][0] for j in ok]))))


def _rank_corpus(run):
    """The ranks' corpus as port tensors on the CPU."""
    from repro_torch.data.docs import DocSet

    inputs = np.load(run["inputs"])
    docs = DocSet(ids=torch.tensor(inputs["ids"]),
                  weights=torch.tensor(inputs["weights"]))
    return docs, torch.tensor(inputs["emb"])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("variant", ["seg", "routed"])
def test_segmented_and_routed_steps_on_a_mesh_of_one_match_reference(
        tmp_path_factory, one, variant):
    """In this process, on a mesh of one: the ranks' engine, index and
    changes; at every version the 1x1 step is the mesh-less step bit for
    bit and within ``test_torch_engine``'s tolerance of the reference's
    single-device step (the routed one before the append)."""
    run = _ranks(tmp_path_factory)
    docs, emb = _rank_corpus(run)
    eng = tlc.SegmentedEngine(docs[slice(*SEGMENTS[0])], emb, device="cpu")
    for lo, hi in SEGMENTS[1:]:
        eng.append(docs[lo:hi])
    idx = ClusterIndex(eng, **CELLS)
    eng.delete(list(DEAD[0]))
    extra = dict(index=idx) if variant == "routed" else {}
    kw = dict(k=KK, bf16_matmul=False, self_exclude=True, row_block=ROW_BLOCK,
              **extra)
    mesh_step = td.build_serve_step(one, engine=eng, **kw)
    flat = td.build_serve_step(engine=eng, **kw)
    qids = torch.arange(QB, dtype=torch.int32)
    for ver in VERSIONS:
        if ver == "delete":
            eng.delete(list(DEAD[1]))
        elif ver == "append":
            idx.add(eng.append(docs[slice(*APPEND)]), docs[slice(*APPEND)])
        elif ver == "compact":
            eng.compact()
            idx.rebuild()
        got = mesh_step(docs[:QB], qids)
        _equal(got, flat(docs[:QB], qids))
        _equal(mesh_step(docs[:QB], qids, tier=2),
               flat(docs[:QB], qids, tier=2))
        want = run["life_ref"].get(f"{variant}/{ver}")
        if want is not None:
            assert_topk_close(got.topk, ttk.TopK(torch.tensor(want[0]),
                                                 torch.tensor(want[1])))


@pytest.mark.timeout(300)
def test_query_server_on_a_mesh_of_one(tmp_path_factory, one):
    """The ranks' server run in this process on a mesh of one: bit for bit
    the mesh-less server (answers, tiers, the lapsed deadline), and the
    reference's server on ``make_host_mesh()``."""
    run = _ranks(tmp_path_factory)
    docs, emb = _rank_corpus(run)
    ids, w = docs.ids.numpy(), docs.weights.numpy()

    def flush(mesh):
        server = tqs.QueryServer(docs, emb, tqs.ServerConfig(
            k=KK, max_batch=SERVER_BATCH, h_max=docs.h_max, degradation=True,
            recover_after=RECOVER_AFTER, device="cpu"), mesh=mesh)
        for j, pick in enumerate(SERVER_PICKS):
            server.submit(ids[pick], w[pick],
                          deadline=LAPSE_S if j == LAPSED else None)
        time.sleep(20 * LAPSE_S)
        return dict(zip(("i", "d", "tier", "err"), torch_mesh_ranks._answers(
            server.flush(), KK)))

    got, same = flush(one), flush(None)
    for key in got:
        assert np.array_equal(got[key], same[key]), key
    _check_server(got, run["server_ref"])


@pytest.mark.timeout(300)
def test_eight_ranks_async_server(tmp_path_factory):
    """The AsyncQueryServer on (4, 2), raw payloads through an ingest pool
    of one worker a rank (the hold-one test compares every rank's answers,
    tiers, errors and stats): the deadline that lapsed on rank 0 alone and
    the submission that rank 0 alone rejected failed on every rank; the
    planned crash failed its batch and the one in flight before it; the
    batch that one rank vectorized differently failed with
    ``MeshDivergence`` and was served nowhere (the dispatch count leaves it
    out); the ingest and the delete took effect; and every tier-0 answer of
    parts A and C is the reference server's within tolerance."""
    run = _ranks(tmp_path_factory)
    r0 = run["ranks"][0]
    err = [str(e) for e in r0["async/err"]]
    n = 3 * ASYNC_PART
    assert err[ASYNC_LAPSED] == "DeadlineExceeded"
    assert err[ASYNC_REJECTED] == "QueryRejected"
    crashed = [j for j in range(n) if err[j] == "WorkerCrashed"]
    assert 0 < len(crashed) <= 2 * ASYNC_BATCH  # the batch, the one before
    odd = [j for j in range(n) if err[j] == "MeshDivergence"]
    assert ASYNC_ODD in odd and len(odd) <= ASYNC_BATCH
    assert err.count("") == n - 2 - len(crashed) - len(odd)
    stats = dict(zip(ASYNC_STATS, r0["async/stats"]))
    assert stats["worker_restarts"] == 1 and stats["deadline_misses"] == 1
    # dispatched: the answered, the batch in flight at the crash; not the
    # crashed batch, not the divergent one
    answered = err.count("")
    assert answered < stats["queries"] < answered + len(crashed)
    assert list(r0["async/ingested"]) == list(range(ASYNC_BASE, 64))
    assert int(r0["async/deleted"]) == len(ASYNC_DEAD)
    ids = r0["async/i"][2 * ASYNC_PART:]
    assert not np.isin(ids, ASYNC_DEAD).any()
    assert np.isin(ids, range(ASYNC_BASE, 64)).any()
    want = run["async_ref"]
    ok = [j for j in [*range(ASYNC_PART), *range(2 * ASYNC_PART, n)]
          if r0["async/tier"][j] == 0 == want[j].tier]
    assert len(ok) >= ASYNC_PART
    assert_topk_close(
        ttk.TopK(torch.as_tensor(r0["async/d"][ok]),
                 torch.as_tensor(r0["async/i"][ok])),
        ttk.TopK(torch.as_tensor(np.stack([want[j][1] for j in ok])),
                 torch.as_tensor(np.stack([want[j][0] for j in ok]))))
