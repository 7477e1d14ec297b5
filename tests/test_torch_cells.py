"""The port's cells of the paper (``repro_torch.configs.lcrwmd``,
``repro_torch.launch.cells``) and the launcher's ``--full`` against the
reference's, on the CPU.

The reference's cells are abstract (``ShapeDtypeStruct`` args for a compile
dry run on ``make_host_mesh()``, one CPU device); the port's args are meta
tensors of the same shapes and dtypes, with the same kind and
``model_flops``.  On a 1x1 mesh the reference pads nothing, so the cells
are equal; on the production meshes the port still pads nothing.  A cell's
``step_fn`` runs a small concrete corpus on a CPU 1x1 mesh as the step it
names does.
"""

import types

import numpy as np
import pytest
import torch

from repro.configs import lcrwmd as jcfg
from repro.launch import cells as jcells
from repro.launch.mesh import make_host_mesh as jmesh
from repro_torch.configs import get_spec
from repro_torch.configs import lcrwmd as tcfg
from repro_torch.convert import from_numpy
from repro_torch.distributed import lcrwmd_dist as td
from repro_torch.launch import cells as tcells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launcher

NAMES = list(get_spec("lcrwmd").shapes)


def _shapes(args):
    """(shape, dtype name) of every leaf of a cell's args."""
    out = []
    for a in args:
        for t in ((a.ids, a.weights) if hasattr(a, "ids") else (a,)):
            out.append((tuple(t.shape), str(t.dtype).replace("torch.", "")))
    return out


def test_config_is_the_references():
    assert tcfg.LCRWMDConfig() == tcfg.LCRWMDConfig(**vars(jcfg.LCRWMDConfig()))
    mine, ref = get_spec("lcrwmd"), jcfg.lcrwmd()
    assert mine.family == ref.family == "lcrwmd"
    assert vars(mine.smoke_cfg) == vars(ref.smoke_cfg)
    assert {k: (c.kind, c.params) for k, c in mine.shapes.items()} == {
        k: (c.kind, c.params) for k, c in ref.shapes.items()}
    assert tcells.all_cells() == [("lcrwmd", s) for s in ref.shapes]


@pytest.mark.parametrize("name", NAMES)
def test_cell_is_the_references_on_one_device(name):
    mine = tcells.build_cell("lcrwmd", name, tmesh.make_host_mesh(device="cpu"))
    ref = jcells.build_cell("lcrwmd", name, jmesh())
    assert (mine.arch_id, mine.shape_id, mine.kind) == (
        ref.arch_id, ref.shape_id, ref.kind)
    assert mine.model_flops == ref.model_flops
    want = [(tuple(s.shape), str(s.dtype)) for s in _leaves(ref.args)]
    assert _shapes(mine.args) == want
    assert all(t.device.type == "meta" for a in mine.args
               for t in ((a.ids, a.weights) if hasattr(a, "ids") else (a,)))


def _leaves(args):
    out = []
    for a in args:
        out += [a.ids, a.weights] if hasattr(a, "ids") else [a]
    return out


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
def test_cells_pad_nothing_on_the_production_mesh(shape):
    """Stand-in mesh objects of the production shapes (no process group):
    the args keep the paper's n and v, where the reference rounds them up
    to its shards."""
    axes = ("pod", "data", "model")[-len(shape):]
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes,
                                 device=torch.device("cpu"),
                                 size=int(np.prod(shape)))
    for name in NAMES:
        cell = tcells.build_cell("lcrwmd", name, mesh)
        p = get_spec("lcrwmd").shapes[name].params
        n = p.get("n_resident", p.get("n_set1"))
        assert cell.args[0].ids.shape[0] == n
        assert cell.args[2].shape[0] == p["vocab"]
        assert f"{shape[0] * shape[-2] if len(shape) == 3 else shape[0]} batch" \
            in cell.notes and "unpadded" in cell.notes


@pytest.mark.parametrize("name", ["serve_1m_k128", "allpairs_64k"])
def test_cell_step_runs_the_step_it_names(small_corpus, name):
    """The cell's step_fn on a small concrete corpus (a 1x1 CPU mesh, the
    cell's bf16_matmul) equals the step built directly, bit for bit."""
    docs, emb = from_numpy(np.asarray(small_corpus.docs.ids),
                           np.asarray(small_corpus.docs.weights),
                           small_corpus.emb, device="cpu")
    one = tmesh.make_host_mesh(device="cpu")
    cell = tcells.build_cell("lcrwmd", name, one)
    q = docs[:6]
    got = cell.step_fn(docs, q, emb)
    if cell.kind == "lcrwmd_allpairs":
        want = td.build_allpairs_d1(one, bf16_matmul=True)(docs, q, emb)
        assert torch.equal(got, want)
        return
    want = td.build_serve_step(one, k=min(128, docs.n_docs),
                               bf16_matmul=True)(docs, q, emb)
    assert torch.equal(got.topk.dists, want.topk.dists)
    assert torch.equal(got.topk.indices, want.topk.indices)
    assert torch.equal(got.d_local, want.d_local)


def test_other_families_wait_for_item_8():
    for arch in ("llama3.2-1b", "nequip", "xdeepfm", "no-such-arch"):
        with pytest.raises(NotImplementedError, match="item 8"):
            tcells.build_cell(arch, "train_4k", None)


@pytest.mark.parametrize("argv", [["--full"], ["--full", "--multi-pod"]])
def test_full_raises_the_production_meshs_error(argv):
    """On a world of one rank the production mesh (256 or 512 ranks)
    refuses, with its own ValueError, before any cell is built."""
    want = "2x16x16" if "--multi-pod" in argv else "16x16"
    with pytest.raises(ValueError, match=f"{want} > 1 ranks"):
        launcher.main(argv + ["--device", "cpu"])


def test_make_args_draws_the_cells_shapes():
    """``make_args`` on a small stand-in cell: the args' shapes and dtypes
    (rows cut), rows sorted with their repeats as end padding (id 0,
    weight 0), L1-normalized weights, queries that copy the first rows,
    and the same draw from the same seed."""
    cell = tcells.Cell("lcrwmd", "small", None,
                       (tcells._docs(3000, 24), tcells._docs(16, 24),
                        tcells._meta((5000, 300), torch.float32)),
                       0.0, "lcrwmd_serve")
    res, q, emb = tcells.make_args(cell, seed=3, device="cpu", rows=2000)
    assert _shapes((res, q, emb)) == [((2000, 24), "int32"),
                                      ((2000, 24), "float32"),
                                      ((16, 24), "int32"), ((16, 24), "float32"),
                                      ((5000, 300), "float32")]
    valid = res.weights > 0
    assert bool(((res.ids[:, 1:] > res.ids[:, :-1]) | ~valid[:, 1:]).all())
    assert bool((valid[:, :-1] | ~valid[:, 1:]).all())
    assert bool((res.ids[~valid] == 0).all()) and bool(valid[:, 0].all())
    torch.testing.assert_close(res.weights.sum(1), torch.ones(2000))
    assert 0 < int((~valid).sum()) and torch.equal(q.ids, res.ids[:16])
    again = tcells.make_args(cell, seed=3, device="cpu", rows=2000)[0]
    assert torch.equal(again.ids, res.ids)
    assert torch.equal(again.weights, res.weights)
    assert abs(float(emb.std()) - 300 ** -0.5) < 1e-3
