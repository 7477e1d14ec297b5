"""Cell builders of the port: (arch x shape x mesh) -> (step_fn, args) for
the paper's own family, ``lcrwmd`` (counterpart of ``repro.launch.cells``).

A :class:`Cell` carries the step a mesh runs, the inputs it takes, and
``model_flops``, the analytic useful FLOPs of one call (the reference's
formulas: phase 1's distance GEMM plus phase 2's SpMM).  The reference's
args are abstract ``ShapeDtypeStruct``s for a compile dry run; the port's
describe the same shapes and dtypes without allocating: ``DocSet``s and an
embedding table of ``device="meta"`` tensors.  Run a cell by passing
concrete tensors of those shapes and dtypes to ``step_fn``.

``step_fn`` is the engine-less, materialized step of
:mod:`repro_torch.distributed.lcrwmd_dist`: ``build_serve_step(mesh, k=,
bf16_matmul=cfg.bf16_matmul)`` for a serve cell, ``build_allpairs_d1`` for
the all-pairs cell, under the mesh given (every rank calls it alike).

No padding: the reference rounds the resident rows up to a multiple of the
batch shards and the vocabulary to a multiple of all the shards so that
its sharded arrays tile evenly.  The port's shards are ragged (ROADMAP,
"No padding for trace reuse"), so ``n`` and ``v`` are the paper's own; on a
1x1 mesh the reference's rounding is the identity and the cells are equal.

Only the ``lcrwmd`` family is built here; any other arch raises
``NotImplementedError``.  The reference's GNN cells are NequIP train steps
and wait for the port's training (ROADMAP A item 8d; NequIP's serving path
is ``repro_torch.models.gnn.nequip``); its LM and recsys cells wait for
items 8c-8e.  The reference's ``donate_argnums`` is left out:
buffer donation means nothing to these callables.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs import ArchSpec, ShapeCell, get_spec
from repro_torch.data.docs import DocSet
from repro_torch.launch.mesh import MODEL_AXIS, batch_axes


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_id: str
    step_fn: Callable
    args: tuple                  # DocSets / tensors on the meta device
    model_flops: float           # analytic useful FLOPs per step
    kind: str
    notes: str = ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _docs(n: int, h: int) -> DocSet:
    return DocSet(ids=_meta((n, h), torch.int32),
                  weights=_meta((n, h), torch.float32))


def _shards(mesh) -> tuple[int, int]:
    """(batch shards, model shards) of ``mesh``."""
    n_batch = 1
    for a in batch_axes(mesh):
        n_batch *= mesh.shape[a]
    return n_batch, mesh.shape[MODEL_AXIS]


def _lcrwmd_cell(spec: ArchSpec, cell: ShapeCell, mesh) -> Cell:
    from repro_torch.distributed.lcrwmd_dist import (build_allpairs_d1,
                                                     build_serve_step)

    cfg = spec.model_cfg
    p = cell.params
    n_batch, n_model = _shards(mesh)
    m = cfg.emb_dim
    if cell.kind == "lcrwmd_serve":
        n, v = p["n_resident"], p["vocab"]
        h, b, hq = p["h_resident"], p["n_query"], p["h_query"]
        k = p.get("k", cfg.k)
        serve = build_serve_step(mesh, k=k, bf16_matmul=cfg.bf16_matmul)
        flops = (2.0 * v * b * hq * m     # phase 1 distance GEMM
                 + 2.0 * n * h * b)       # phase 2 SpMM
        return Cell(spec.arch_id, cell.name,
                    lambda r, q, e: serve(r, q, e),
                    (_docs(n, h), _docs(b, hq), _meta((v, m), torch.float32)),
                    flops, "lcrwmd_serve",
                    notes=f"n={n} v={v} unpadded: rows over {n_batch} batch "
                          f"shard(s), vocabulary over {n_model * n_batch} "
                          "(full-mesh phase 1), ragged")
    if cell.kind == "lcrwmd_allpairs":
        n1, n2, h, v = p["n_set1"], p["n_set2"], p["h"], p["vocab"]
        d1 = build_allpairs_d1(mesh, bf16_matmul=cfg.bf16_matmul)
        flops = 2.0 * v * n2 * h * m + 2.0 * n1 * h * n2
        return Cell(spec.arch_id, cell.name, lambda a, b_, e: d1(a, b_, e),
                    (_docs(n1, h), _docs(n2, h), _meta((v, m), torch.float32)),
                    flops, "lcrwmd_allpairs",
                    notes=f"n1={n1} v={v} unpadded: rows over {n_batch} "
                          f"batch shard(s), vocabulary over "
                          f"{n_model * n_batch} (full-mesh phase 1), ragged")
    raise ValueError(cell.kind)


ZIPF_CHUNK_ROWS = 1 << 18   # rows drawn at a time by make_args


def make_args(cell: Cell, *, seed: int = 0, device=None,
              rows: int | None = None) -> tuple:
    """Concrete inputs of ``cell.args``' shapes and dtypes, drawn on
    ``device`` (``None``: the card) from ``seed``, for an ``lcrwmd`` cell.

    Each resident row takes ``h`` draws from a Zipf law (exponent 1) over a
    random permutation of the cell's vocabulary, sorted; repeats become
    padding slots (id 0, weight 0, at the row's end, as ``DocSet`` pads).
    Weights are uniform in (0, 1], L1-normalized; the embedding is
    N(0, 1)/sqrt(m).  The queries (the all-pairs cell's second set) are
    copies of resident rows 0..B-1.  ``rows`` cuts the resident rows (at
    least B).
    """
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    resident, queries, emb = cell.args
    n, h = resident.ids.shape
    n = n if rows is None else max(int(rows), queries.n_docs)
    v, m = emb.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(v, generator=g, device=dev)
    cdf = torch.cumsum(1.0 / torch.arange(1, v + 1, device=dev,
                                          dtype=torch.float64), 0)
    cdf /= cdf[-1].clone()
    ids = torch.empty((n, h), dtype=resident.ids.dtype, device=dev)
    w = torch.empty((n, h), dtype=resident.weights.dtype, device=dev)
    for lo in range(0, n, ZIPF_CHUNK_ROWS):
        hi = min(lo + ZIPF_CHUNK_ROWS, n)
        u = torch.rand((hi - lo) * h, generator=g, device=dev,
                       dtype=torch.float64)
        r = torch.searchsorted(cdf, u).clamp_(max=v - 1)
        x = perm[r].view(hi - lo, h).sort(dim=1).values
        rep = torch.zeros_like(x, dtype=torch.bool)
        rep[:, 1:] = x[:, 1:] == x[:, :-1]
        x = torch.where(rep, v, x).sort(dim=1).values   # repeats to the end
        pad = x == v
        wt = 1.0 - torch.rand(x.shape, generator=g, device=dev)   # (0, 1]
        wt = torch.where(pad, 0.0, wt)
        ids[lo:hi] = torch.where(pad, 0, x)
        w[lo:hi] = wt / wt.sum(dim=1, keepdim=True)
    table = torch.randn((v, m), generator=g, device=dev,
                        dtype=emb.dtype) / m ** 0.5
    res = DocSet(ids=ids, weights=w)
    return res, res[:queries.n_docs], table


def build_cell(arch_id: str, shape_id: str, mesh) -> Cell:
    """The cell ``shape_id`` of ``arch_id`` on ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`, or any object with its ``shape``,
    ``axis_names`` and ``device``)."""
    if arch_id != "lcrwmd":
        raise NotImplementedError(
            f"{arch_id}: the port builds the lcrwmd cells only; the GNN "
            "cells are train steps and wait for the port's training (ROADMAP "
            "A item 8d), the LM and recsys cells for items 8c-8e")
    spec = get_spec(arch_id)
    cell = spec.shapes[shape_id]
    if cell.skip_reason:
        raise ValueError(f"cell {arch_id}/{shape_id} skipped: {cell.skip_reason}")
    return _lcrwmd_cell(spec, cell, mesh)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) pair of the families the port builds: the
    paper's own."""
    return [("lcrwmd", s) for s in get_spec("lcrwmd").shapes]


__all__ = ["Cell", "all_cells", "build_cell", "make_args"]
