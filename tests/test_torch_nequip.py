"""The port's NequIP (``repro_torch.models.gnn``) against the reference
(``repro.models.gnn``) on the same numpy inputs and weights, and B9's
autograd Function against autograd through its plain version.

The reference's outputs are computed once, jitted, in module-scoped
fixtures; the property and finite-difference checks run on the port only.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from repro.configs import get_spec as ref_spec
from repro.models.gnn import nequip as RN
from repro.models.gnn import sampler as RS
from repro.models.gnn import so3 as RSO3
from repro_torch import convert
from repro_torch.configs import get_spec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import segment_spmm as tseg
from repro_torch.models.gnn import nequip as TN
from repro_torch.models.gnn import sampler as TS
from repro_torch.models.gnn import so3 as TSO3

SMOKE = dict(n_layers=2, d_hidden=8, l_max=2, n_rbf=4, cutoff=5.0)
FEAT = dict(n_layers=1, d_hidden=8, l_max=1, n_rbf=4, d_feat=12)
E_TOL = dict(rtol=1e-5, atol=1e-5)
F_ATOL = 1e-4


def _mk_batch(n=24, e=96, seed=0, n_graphs=2, d_feat=0):
    """The reference's test batch (tests/test_nequip.py), in numpy: random
    (unsorted) edges with no self-loop, positions in a box of 4 (some
    edges longer than the 5.0 cutoff)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 4.0, (n, 3)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    ok = src != dst
    src, dst = np.where(ok, src, (src + 1) % n), dst
    batch = {
        "positions": pos,
        "edge_index": np.stack([src, dst]),
        "edge_mask": np.ones(e, bool),
        "node_mask": np.ones(n, bool),
        "graph_ids": (np.arange(n) % n_graphs).astype(np.int32),
        "n_graphs": n_graphs,
        "species": rng.integers(0, 4, n).astype(np.int32),
        "energies": rng.normal(size=n_graphs).astype(np.float32),
        "forces": rng.normal(size=(n, 3)).astype(np.float32),
    }
    if d_feat:
        batch["node_feat"] = rng.normal(size=(n, d_feat)).astype(np.float32)
    return batch


def _padded(batch):
    """The reference's test_padding_invariance batch: 8 masked edges that
    point anywhere and 4 masked nodes far away."""
    n = batch["positions"].shape[0]
    extra = np.random.default_rng(1).integers(0, n, (2, 8)).astype(np.int32)
    return dict(
        batch,
        edge_index=np.concatenate([batch["edge_index"], extra], axis=1),
        edge_mask=np.concatenate([batch["edge_mask"], np.zeros(8, bool)]),
        positions=np.concatenate([batch["positions"],
                                  np.full((4, 3), 77.0, np.float32)]),
        node_mask=np.concatenate([batch["node_mask"], np.zeros(4, bool)]),
        graph_ids=np.concatenate([batch["graph_ids"], np.zeros(4, np.int32)]),
        species=np.concatenate([batch["species"], np.zeros(4, np.int32)]),
        forces=np.concatenate([batch["forces"], np.zeros((4, 3), np.float32)]))


@functools.lru_cache(maxsize=None)
def _ref_fn(kind: str, cfg: RN.NequIPConfig, n_graphs: int):
    """Jitted reference function (cfg and n_graphs static)."""
    if kind == "ef":
        f = lambda p, b: RN.forward_energy_forces(p, dict(b, n_graphs=n_graphs),
                                                  cfg)
    else:
        f = lambda p, b: RN.nequip_loss(p, dict(b, n_graphs=n_graphs), cfg)[0]
    return jax.jit(f)


def _ref_run(kind, cfg, params, batch):
    b = {k: jnp.asarray(v) for k, v in batch.items() if k != "n_graphs"}
    out = _ref_fn(kind, cfg, batch["n_graphs"])(params, b)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def models():
    """{name: (ref cfg, ref params as numpy, port cfg, port params)}."""
    out = {}
    for name, kw in (("species", SMOKE), ("feat", FEAT)):
        rcfg = RN.NequIPConfig(**kw)
        rp = jax.tree.map(np.asarray, RN.init_params(jax.random.key(0), rcfg))
        tcfg = TN.NequIPConfig(**kw)
        out[name] = (rcfg, rp, tcfg,
                     convert.nequip_params_from_numpy(rp, tcfg, device="cpu"))
    return out


@pytest.fixture(scope="module")
def batches():
    base = _mk_batch()
    return {"species": base, "feat": _mk_batch(d_feat=12),
            "padded": _padded(base),
            # positions spread 2x: most edges beyond the cutoff
            "cutoff": dict(base, positions=base["positions"] * 2.0)}


@pytest.fixture(scope="module")
def ref_out(models, batches):
    """Reference (energies, forces) per (model, batch), jitted once."""
    out = {}
    for model, name in (("species", "species"), ("feat", "feat"),
                        ("species", "padded"), ("species", "cutoff")):
        rcfg, rp = models[model][:2]
        out[name] = _ref_run("ef", rcfg, rp, batches[name])
    return out


# ---------------------------------------------------------------------------
# so3 and the radial basis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("path", RN._paths(2))
def test_cg_real_bit_identical(path):
    assert np.array_equal(TSO3.cg_real(*path), RSO3.cg_real(*path))


def test_spherical_harmonics_match():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(200, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    want = RSO3.sph_harm_all(jnp.asarray(v), 2)
    got = TSO3.sph_harm_all(torch.tensor(v), 2)
    for l in range(3):
        np.testing.assert_allclose(got[l].numpy(), np.asarray(want[l]),
                                   rtol=0, atol=1e-7)
    with pytest.raises(NotImplementedError):
        TSO3.sph_harm_all(torch.tensor(v), 3)


def test_bessel_rbf_matches():
    """At 0 (clamped to 1e-9), inside, at and beyond the cutoff."""
    r = np.concatenate([[0.0, 1e-12, 1e-9, 5.0, 5.0001, 7.5],
                        np.random.default_rng(4).uniform(0, 6, 300)])
    r = r.astype(np.float32)
    want = np.asarray(RN.bessel_rbf(jnp.asarray(r), 8, 5.0))
    got = TN.bessel_rbf(torch.tensor(r), 8, 5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[3:6].any()   # the envelope is exactly 0 from the cutoff on


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["species", "feat", "padded", "cutoff"])
def test_energies_match_reference(models, batches, ref_out, name):
    """The smoke config on species and (l_max 1) on 12 continuous features;
    the padded batch; a batch with most edges beyond the cutoff."""
    _, _, tcfg, tp = models["feat" if name == "feat" else "species"]
    b = convert.nequip_batch_from_numpy(batches[name], device="cpu")
    got = TN.forward_energy(tp, b, tcfg)
    np.testing.assert_allclose(got.numpy(), ref_out[name][0], **E_TOL)


@pytest.mark.parametrize("name", ["species", "feat", "padded", "cutoff"])
def test_forces_match_reference(models, batches, ref_out, name):
    _, _, tcfg, tp = models["feat" if name == "feat" else "species"]
    b = convert.nequip_batch_from_numpy(batches[name], device="cpu")
    e, f = TN.forward_energy_forces(tp, b, tcfg)
    np.testing.assert_allclose(e.numpy(), ref_out[name][0], **E_TOL)
    np.testing.assert_allclose(f.numpy(), ref_out[name][1], rtol=0,
                               atol=F_ATOL)
    assert e.grad_fn is None and f.grad_fn is None


@pytest.mark.parametrize("weight", [1.0, 0.0])
def test_loss_matches_reference(models, batches, weight):
    rcfg, rp, tcfg, tp = models["species"]
    rcfg = dataclasses.replace(rcfg, force_loss_weight=weight)
    tcfg = dataclasses.replace(tcfg, force_loss_weight=weight)
    want = _ref_run("loss", rcfg, rp, batches["species"])
    b = convert.nequip_batch_from_numpy(batches["species"], device="cpu")
    got, parts = TN.nequip_loss(tp, b, tcfg)
    np.testing.assert_allclose(got.item(), want, **E_TOL)
    assert (parts["force_mse"].item() == 0.0) == (weight == 0.0)


def test_padding_leaves_energies_and_forces(models, batches):
    """The port alone: masked edges and nodes change nothing."""
    _, _, tcfg, tp = models["species"]
    e0, f0 = TN.forward_energy_forces(tp, convert.nequip_batch_from_numpy(
        batches["species"], device="cpu"), tcfg)
    e1, f1 = TN.forward_energy_forces(tp, convert.nequip_batch_from_numpy(
        batches["padded"], device="cpu"), tcfg)
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f1[:24], f0, rtol=0, atol=1e-6)
    assert not f1[24:].any()


# ---------------------------------------------------------------------------
# the port's own properties
# ---------------------------------------------------------------------------
def test_energy_invariant_under_rotation_translation(models, batches):
    """E(R·x + t) == E(x), at the reference's own tolerance."""
    _, _, tcfg, tp = models["species"]
    b = convert.nequip_batch_from_numpy(batches["species"], device="cpu")
    e0 = TN.forward_energy(tp, b, tcfg)
    for seed in range(3):
        rot = torch.tensor(Rotation.random(random_state=seed).as_matrix(),
                           dtype=torch.float32)
        t = torch.tensor([1.3, -0.7, 2.1])
        e1 = TN.forward_energy(tp, dict(b, positions=b["positions"] @ rot.T + t),
                               tcfg)
        torch.testing.assert_close(e1, e0, rtol=5e-5, atol=5e-5)


def test_forces_equivariant_under_rotation(models, batches):
    """F(R·x) == R·F(x)."""
    _, _, tcfg, tp = models["species"]
    b = convert.nequip_batch_from_numpy(batches["species"], device="cpu")
    _, f0 = TN.forward_energy_forces(tp, b, tcfg)
    rot = torch.tensor(Rotation.random(random_state=7).as_matrix(),
                       dtype=torch.float32)
    _, f1 = TN.forward_energy_forces(tp, dict(b, positions=b["positions"] @ rot.T),
                                     tcfg)
    torch.testing.assert_close(f1, f0 @ rot.T, rtol=1e-4, atol=1e-4)


def test_forces_are_exact_gradient(models):
    """Central differences of the float32 energy at eps 1e-3, at the
    reference's own tolerance (its test_forces_are_exact_gradient)."""
    _, _, tcfg, tp = models["species"]
    b = convert.nequip_batch_from_numpy(_mk_batch(n=10, e=40), device="cpu")
    _, f = TN.forward_energy_forces(tp, b, tcfg)
    eps = 1e-3
    for i, d in [(0, 0), (3, 1), (7, 2)]:
        pp, pm = b["positions"].clone(), b["positions"].clone()
        pp[i, d] += eps
        pm[i, d] -= eps
        e_p = TN.forward_energy(tp, dict(b, positions=pp), tcfg).sum().item()
        e_m = TN.forward_energy(tp, dict(b, positions=pm), tcfg).sum().item()
        np.testing.assert_allclose(f[i, d].item(), -(e_p - e_m) / (2 * eps),
                                   rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("chunk", [1, 5, 40])
def test_edge_chunks_equal_one_chunk(models, batches, chunk):
    """Chunks of whole destination rows give one chunk's energies and
    forces (CPU BLAS may round other row counts apart, so not bit for
    bit: within 1e-6 relative)."""
    _, _, tcfg, tp = models["species"]
    b = convert.nequip_batch_from_numpy(batches["padded"], device="cpu")
    e0, f0 = TN.forward_energy_forces(tp, b, tcfg)
    e1, f1 = TN.forward_energy_forces(tp, b, tcfg, edge_chunk=chunk)
    torch.testing.assert_close(e1, e0, rtol=1e-6, atol=1e-6 * e0.abs().max().item())
    torch.testing.assert_close(f1, f0, rtol=1e-6, atol=1e-6 * f0.abs().max().item())


def test_edge_chunk_plan():
    """Whole rows, at most edge_chunk edges, a row larger than a chunk
    alone (with the empty rows before it), every row and edge once."""
    deg = np.array([0, 3, 1, 0, 9, 2, 2, 0, 0, 1, 0])
    off = np.concatenate([[0], np.cumsum(deg)])
    for chunk in (1, 2, 4, 5, 100):
        plan = TN._edge_chunks(off, chunk)
        assert plan[0][0] == 0 and plan[-1][1] == len(deg)
        assert all(a[1] == b[0] and a[3] == b[2] for a, b in zip(plan, plan[1:]))
        for r0, r1, e0, e1 in plan:
            assert (e0, e1) == (off[r0], off[r1])
            assert e1 - e0 <= chunk or np.count_nonzero(deg[r0:r1]) == 1
            assert e1 > e0 or r1 == len(deg)
    assert TN._edge_chunks(off, 100) == [(0, 11, 0, 18)]
    assert TN._edge_chunks(off, 2)[:2] == [(0, 2, 0, 3), (2, 4, 3, 4)]
    with pytest.raises(ValueError):
        TN._edge_chunks(off, 0)


def test_forward_runs_b9_for_every_gather_and_aggregation(models, batches,
                                                          monkeypatch):
    """Each block gathers and aggregates through the Function (one call a
    chunk each), the geometry gathers twice; the backward for the forces
    calls it once more a block for the aggregation, once a block for each
    gather whose features need a gradient (all but the first block's) and
    twice for the positions."""
    _, _, tcfg, tp = models["species"]
    b = convert.nequip_batch_from_numpy(batches["species"], device="cpu")
    calls = []
    plain = tseg.segment_spmm
    monkeypatch.setattr(tseg, "segment_spmm",
                        lambda *a: calls.append(a[3].shape[0]) or plain(*a))
    with torch.no_grad():
        TN.forward_energy(tp, b, tcfg, edge_chunk=30)
    off = np.bincount(b["edge_index"][1].numpy(), minlength=24)
    n_chunks = len(TN._edge_chunks(np.concatenate([[0], np.cumsum(off)]), 30))
    assert n_chunks > 1
    assert len(calls) == 2 + 2 * tcfg.n_layers * n_chunks
    calls.clear()
    TN.forward_energy_forces(tp, b, tcfg)
    assert len(calls) == (2 + 2 * tcfg.n_layers) + (2 * tcfg.n_layers + 1)


def test_masked_edges_do_not_pile_onto_one_row(models, batches, monkeypatch):
    """Padding edges at (0, 0), as the sampler pads: the energies and
    forces are those without them, and no row that B9 sums holds more
    edges than the real graph's busiest row plus its share of the padding
    (60 over 24 nodes: 3), where one row would take all 60."""
    _, _, tcfg, tp = models["species"]
    base = batches["species"]
    padded = dict(base,
                  edge_index=np.concatenate(
                      [base["edge_index"], np.zeros((2, 60), np.int32)], 1),
                  edge_mask=np.concatenate([base["edge_mask"],
                                            np.zeros(60, bool)]))
    b0 = convert.nequip_batch_from_numpy(base, device="cpu")
    b1 = convert.nequip_batch_from_numpy(padded, device="cpu")
    rows = []
    plain = tseg.segment_spmm
    monkeypatch.setattr(tseg, "segment_spmm", lambda *a: rows.append(
        int(torch.bincount(a[1].long()).max())) or plain(*a))
    e0, f0 = TN.forward_energy_forces(tp, b0, tcfg)
    busiest = max(rows)
    rows.clear()
    e1, f1 = TN.forward_energy_forces(tp, b1, tcfg)
    assert max(rows) <= busiest + 3
    torch.testing.assert_close(e1, e0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(f1, f0, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# B9 under autograd
# ---------------------------------------------------------------------------
def _graph(seed, sorted_src):
    g = torch.Generator().manual_seed(seed)
    n_src, n_dst, e, d = 40, 30, 300, 12
    dst = torch.sort(torch.randint(0, n_dst - 3, (e,), generator=g)).values
    src = (torch.sort(torch.randint(0, n_src, (e,), generator=g)).values
           if sorted_src else torch.randint(0, n_src, (e,), generator=g))
    feat = torch.randn(n_src, d, generator=g, requires_grad=True)
    rad = torch.rand(e, generator=g).requires_grad_(True)
    return src.to(torch.int32), dst.to(torch.int32), feat, rad, n_dst


@pytest.mark.parametrize("sorted_src", [False, True])
def test_function_first_and_second_derivatives_match_plain(sorted_src):
    """The Function against autograd through ``segment_spmm_plain``: values,
    first derivatives in feat and rad (rows with no edge included), and
    second derivatives of a function of those first derivatives."""
    src, dst, feat, rad, n = _graph(5, sorted_src)
    w = torch.randn(n, feat.shape[1], generator=torch.Generator().manual_seed(6))

    def derivs(fn):
        y = fn(src, dst, feat, rad, n)
        gf, gr = torch.autograd.grad((y * w).sum(), (feat, rad),
                                     create_graph=True)
        s = (gf * gf).sum() + (gr * gr * rad).sum() + (gr * feat[:, 0].sum()).sum()
        return (y, gf, gr) + torch.autograd.grad(s, (feat, rad))

    got = derivs(ops.segment_spmm)
    want = derivs(tseg.segment_spmm_plain)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert not got[0][n - 3:].any()


def test_function_backward_skips_the_sort_for_ascending_src(monkeypatch):
    src, dst, feat, rad, n = _graph(7, True)
    sorts = []
    real = torch.argsort
    monkeypatch.setattr(torch, "argsort", lambda *a, **k: sorts.append(1) or
                        real(*a, **k))
    (ops.segment_spmm(src, dst, feat, rad.detach(), n) ** 2).sum().backward()
    assert sorts == []
    src2 = src.flip(0).contiguous()
    (ops.segment_spmm(src2, dst, feat, rad.detach(), n) ** 2).sum().backward()
    assert sorts == [1]
    assert _build.LAUNCHES["segment_spmm"] == 0   # CPU: the plain version


# ---------------------------------------------------------------------------
# sampler, config, converters
# ---------------------------------------------------------------------------
def test_random_graph_equals_reference():
    for kw in (dict(d_feat=0), dict(d_feat=6, n_species=4, box=3.0)):
        want = RS.random_graph(500, 8.0, seed=3, **kw)
        got = TS.random_graph(500, 8.0, seed=3, **kw)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert (a is None and b is None) or (
                a.dtype == b.dtype and np.array_equal(a, b)), f.name


def test_fanout_sampler_equals_reference():
    """The same arrays for the same seed, with node and edge caps that
    bind (padding included)."""
    for d_feat, caps in ((0, (2048, 8192)), (5, (300, 400))):
        want_g = RS.random_graph(500, 8, seed=0, d_feat=d_feat)
        got_g = TS.random_graph(500, 8, seed=0, d_feat=d_feat)
        seeds = np.random.default_rng(0).choice(500, size=32, replace=False)
        want = RS.sample_fanout_subgraph(
            want_g, seeds, fanout=(15, 10), rng=np.random.default_rng(1),
            max_nodes=caps[0], max_edges=caps[1])
        got = TS.sample_fanout_subgraph(
            got_g, seeds, fanout=(15, 10), rng=np.random.default_rng(1),
            max_nodes=caps[0], max_edges=caps[1])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(
                got[k], want[k]), k


def test_registered_spec_equals_reference():
    want, got = ref_spec("nequip"), get_spec("nequip")
    assert (got.arch_id, got.family, got.notes) == (want.arch_id, want.family,
                                                    want.notes)
    for a in ("model_cfg", "smoke_cfg"):
        assert dataclasses.asdict(getattr(got, a)) == dataclasses.asdict(
            getattr(want, a))
    assert list(got.shapes) == list(want.shapes)
    for k, c in want.shapes.items():
        assert dataclasses.asdict(got.shapes[k]) == dataclasses.asdict(c)


def test_init_params_shapes_and_scales():
    """The reference's shapes (every leaf), zero biases, normal / sqrt(fan_in)
    by a seeded generator: the same numbers for the same seed."""
    for kw in (SMOKE, FEAT):
        rcfg, tcfg = RN.NequIPConfig(**kw), TN.NequIPConfig(**kw)
        want = jax.eval_shape(lambda k: RN.init_params(k, rcfg),
                              jax.random.key(0))
        got = TN.init_params(tcfg, seed=0, device="cpu")
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert not got["head_b1"].any() and not got["layers"][0]["rad_b1"].any()
        again = TN.init_params(tcfg, seed=0, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got),
                                                    jax.tree.leaves(again)))
    big = TN.init_params(get_spec("nequip").model_cfg, seed=1, device="cpu")
    w = big["layers"][0]["rad_w2"]
    assert abs(w.std().item() * 64 ** 0.5 - 1.0) < 0.02


def test_converters_check_and_default_to_the_card(models):
    rcfg, rp, tcfg, _ = models["species"]
    with pytest.raises(ValueError, match="layers"):
        convert.nequip_params_from_numpy(
            rp, dataclasses.replace(tcfg, n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.nequip_params_from_numpy(
            rp, dataclasses.replace(tcfg, d_hidden=4), device="cpu")
    b = convert.nequip_batch_from_numpy(_mk_batch(), device="cpu")
    assert b["n_graphs"] == 2 and b["edge_mask"].dtype == torch.bool
    if torch.cuda.is_available():
        pytest.skip("the card is there: the defaults would succeed")
    for call in (lambda: TN.init_params(tcfg),
                 lambda: convert.nequip_params_from_numpy(rp, tcfg),
                 lambda: convert.nequip_batch_from_numpy(_mk_batch())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
