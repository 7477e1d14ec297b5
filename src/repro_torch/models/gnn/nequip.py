"""NequIP (arXiv:2101.03164): an E(3)-equivariant interatomic potential,
served on the card: per-graph energies and forces F = -dE/dx.

Counterpart of ``repro.models.gnn.nequip``, with the same configuration,
parameter layout and function.  Node features are a dict ``{l: (N, C,
2l+1)}`` (component-normalized irreps, C channels each).  One interaction
block:

    linear_self -> TP-conv(messages over edges) -> linear_out -> gate

Energy head: scalar channels -> MLP -> per-atom energy -> an indexed add
over graphs.  Forces are ``torch.autograd.grad`` of the summed energy with
respect to the positions.

Where the reference gathers and scatters with indexing and
``jax.ops.segment_sum``, the port runs kernel B9 (``ops.segment_spmm``,
the TPU kernel ``segment_spmm_pallas``'s function) under autograd:

- the edges are sorted by destination once a forward (a stable sort, so
  each node still sums its edges in their original order), masked edges
  first spread over the nodes as self-loops (they add exactly 0);
- the positions' gathers by edge end (``pos[dst]``, ``pos[src]``) and each
  block's gather of source features are B9 launches with ``dst =
  arange(E)`` and weight 1 (a copy of each row), so their gradients are
  B9 over the edges ordered by source;
- each block's aggregation is one B9 launch over the messages of every
  irrep order at once, ``(E, (l_max+1)²·C)`` with ``src = arange(E)``,
  whose gradient is one more B9 launch in the identity order.

So the backward that gives the forces adds with no atomics.  The energy
readout over ``graph_ids`` (unsorted, N to G) stays an indexed add, in
float64.

``forward_energy(..., edge_chunk=)`` runs each block's edge work in chunks
of whole destination rows (at most ``edge_chunk`` edges, or one row's
edges where a row holds more), each chunk's B9 writing its own rows; the
function is unchanged, and the chunk's temporaries (about 3,000 floats an
edge at the ``nequip`` config) bound the memory of a large graph.

The tensor product contracts the edge harmonics with the CG tensors first,
into ``(E, Σ d1, d3)`` per output order, and then the path-weighted
source features with it in one batched product per output order (the
reference's three-operand einsum would build ``(E, C, d1, d2)``
intermediates).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels import segment_spmm as _seg
from repro_torch.models.gnn.so3 import cg_real, sph_harm_all

# B9 under autograd; chip_smoke.py swaps in the plain version through this
# name to hold the model on the kernel against the model without it.
segment_spmm = ops.segment_spmm


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channels per irrep order
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    d_feat: int = 0             # >0: continuous node features (embedded)
    radial_hidden: int = 64
    avg_neighbors: float = 16.0  # message normalization
    force_loss_weight: float = 1.0
    dtype: str = "float32"


def _paths(l_max: int):
    """All CG paths (l_in, l_sh, l_out) with every l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


# ---------------------------------------------------------------------------
# radial basis
# ---------------------------------------------------------------------------
def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with polynomial cutoff envelope. r (E,) -> (E,K)."""
    # maximum (not clamp): a tie splits its gradient, as jnp.maximum's does
    r = torch.maximum(r, r.new_tensor(1e-9))
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    # sqrt rounded in float32, as jnp.sqrt of the weakly typed constant
    s = float(np.sqrt(np.float32(2.0 / cutoff)))
    b = s * torch.sin(n * math.pi * r[:, None] / cutoff) / r[:, None]
    # p=6 polynomial envelope (smooth to zero at the cutoff).
    u = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8
    return b * env[:, None]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def param_shapes(cfg: NequIPConfig) -> dict:
    """The parameter tree with ``(shape, fan_in)`` leaves, in the
    reference's order of draws; ``fan_in`` None marks a zero bias."""
    c = cfg.d_hidden
    ls = range(cfg.l_max + 1)
    n_paths = len(_paths(cfg.l_max))
    layer = {
        "lin_in": {l: ((c, c), c) for l in ls},
        "lin_out": {l: ((c, c), c) for l in ls},
        "rad_w1": ((cfg.n_rbf, cfg.radial_hidden), cfg.n_rbf),
        "rad_b1": ((cfg.radial_hidden,), None),
        "rad_w2": ((cfg.radial_hidden, n_paths * c), cfg.radial_hidden),
        "gate_w": {l: ((c, c), c) for l in ls if l > 0},
    }
    embed = (((cfg.d_feat, c), cfg.d_feat) if cfg.d_feat > 0
             else ((cfg.n_species, c), 1))
    return {"embed": embed, "layers": [layer] * cfg.n_layers,
            "head_w1": ((c, c), c), "head_b1": ((c,), None),
            "head_w2": ((c, 1), c)}


def init_params(cfg: NequIPConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator``, shaped and scaled
    as the reference's ``init_params`` (normal / sqrt(fan_in), zero biases;
    its numbers differ: carry the reference's weights with
    ``convert.nequip_params_from_numpy`` to compare the two)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    g = torch.Generator(device=dev).manual_seed(seed)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        shape, fan_in = node
        if fan_in is None:
            return torch.zeros(shape, dtype=dtype, device=dev)
        x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
        return x.mul_(fan_in ** -0.5).to(dtype)

    return build(param_shapes(cfg))


# ---------------------------------------------------------------------------
# the tensor product's constants
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _OutOrder:
    """The CG paths into one output order ``l3``: ``paths`` (path index,
    l1), ``k`` the summed input widths, ``cols`` its columns in ``G``."""
    l3: int
    paths: tuple
    k: int
    cols: tuple


@functools.lru_cache(maxsize=None)
def _tp_plan(l_max: int):
    """(per output order an :class:`_OutOrder`, G (S, T) float32): the
    harmonics (E, S), S = (l_max+1)², times G give each output order's
    ``(E, k, 2l3+1)`` block, ``A[e, (p, m), q] = Σ_n sh_l2[e, n]
    cg_p[m, n, q]``, side by side in T columns."""
    paths = _paths(l_max)
    s = (l_max + 1) ** 2
    orders, cols = [], []
    t = 0
    for l3 in range(l_max + 1):
        d3 = 2 * l3 + 1
        mine = [(p, l1, l2) for p, (l1, l2, o) in enumerate(paths) if o == l3]
        k = sum(2 * l1 + 1 for _, l1, _ in mine)
        block = np.zeros((s, k, d3))
        kb = 0
        for p, l1, l2 in mine:
            cg = cg_real(l1, l2, l3)                  # (d1, d2, d3)
            block[l2 * l2:(l2 + 1) ** 2, kb:kb + 2 * l1 + 1, :] = \
                cg.transpose(1, 0, 2)
            kb += 2 * l1 + 1
        orders.append(_OutOrder(l3, tuple((p, l1) for p, l1, _ in mine), k,
                                (t, t + k * d3)))
        cols.append(block.reshape(s, k * d3))
        t += k * d3
    return tuple(orders), np.concatenate(cols, axis=1).astype(np.float32)


def _messages(f_edge, sh, w_all, orders, g):
    """(E, S·C) messages of every output order, components outer and
    channels inner: f_edge (E, S, C), sh (E, S), w_all (E, P, C) (masked),
    g the plan's G on the device.  (Channels inner, so that each
    concatenation copies rows of C floats: along a last axis of 1-22
    floats ``torch.cat`` ran 3x slower on the card.)"""
    e, s, c = f_edge.shape
    a = sh @ g                                       # (E, T)
    out = []
    for o in orders:
        d3 = 2 * o.l3 + 1
        parts = [f_edge[:, l1 * l1:(l1 + 1) ** 2, :] * w_all[:, p, None, :]
                 for p, l1 in o.paths]
        fw = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        blk = a[:, o.cols[0]:o.cols[1]].view(e, o.k, d3)
        out.append(torch.matmul(blk.transpose(1, 2), fw))   # (E, 2l3+1, C)
    return torch.cat(out, dim=1).reshape(e, s * c)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _edge_chunks(off: np.ndarray, edge_chunk: int) -> list:
    """[(r0, r1, e0, e1)]: whole destination rows [r0, r1) and their edges
    [e0, e1), at most ``edge_chunk`` edges a chunk unless one row holds
    more (it goes in a chunk alone, with the empty rows before it).
    ``off`` (N + 1,) is the CSR row pointer of the sorted destinations."""
    if edge_chunk < 1:
        raise ValueError(f"edge_chunk must be >= 1, got {edge_chunk}")
    n = len(off) - 1
    out, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(off, off[r0] + edge_chunk, side="right")) - 1
        if off[r1] == off[r0]:   # the next row with an edge holds too many
            r1 = int(np.searchsorted(off, off[r0], side="right"))
        r1 = min(r1, n)
        out.append((r0, r1, int(off[r0]), int(off[r1])))
        r0 = r1
    return out


def _gather(x, idx, ar, one):
    """x[idx] (len(idx), D) as B9 with dst = arange and weight 1."""
    e = idx.shape[0]
    return segment_spmm(idx, ar[:e], x, one[:e], e)


def _conv_layer(lp, feats, geo, cfg, chunks):
    """One NequIP interaction block. feats: {l: (N,C,2l+1)}."""
    c, s = cfg.d_hidden, (cfg.l_max + 1) ** 2
    ls = sorted(feats.keys())
    n = feats[0].shape[0]
    n_paths = len(_paths(cfg.l_max))

    # self-interaction (channel mixing, per irrep order), as one (N, S·C)
    # (components outer, channels inner)
    f_in = torch.cat([torch.einsum("ncm,cd->nmd", feats[l], lp["lin_in"][l])
                      for l in ls], dim=1).reshape(n, s * c)

    parts = []
    for r0, r1, e0, e1 in chunks:
        ec = e1 - e0
        # gather source-node features per edge
        f_edge = _gather(f_in, geo["src"][e0:e1], geo["ar"],
                         geo["one"]).view(ec, s, c)
        # radial weights per path/channel; the mask (0 or 1) scales h, so
        # that (h · mask) @ W equals the reference's (h @ W) · mask
        h = F.silu(torch.addmm(lp["rad_b1"], geo["rbf"][e0:e1],
                               lp["rad_w1"]))
        h = h * geo["mask"][e0:e1, None]
        w_all = (h @ lp["rad_w2"]).reshape(ec, n_paths, c)
        msgs = _messages(f_edge, geo["sh"][e0:e1], w_all, geo["orders"],
                         geo["g"])
        # sum into the chunk's destination rows (B9, no atomics)
        dst = geo["dst"][e0:e1] - r0 if r0 else geo["dst"][e0:e1]
        parts.append(segment_spmm(geo["ar"][:ec], dst, msgs,
                                  geo["one"][:ec], r1 - r0))
    agg = torch.cat(parts) if len(parts) > 1 else parts[0]
    agg = (agg * (1.0 / math.sqrt(cfg.avg_neighbors))).view(n, s, c)

    # output self-interaction + residual
    out = {l: torch.einsum("nmc,cd->ndm", agg[:, l * l:(l + 1) ** 2, :],
                           lp["lin_out"][l]) for l in ls}

    # gate nonlinearity: scalars -> silu; l>0 gated by learned scalars
    scal = out[0][..., 0]  # (N, C)
    new = {0: (feats[0][..., 0] + F.silu(scal))[..., None]}
    for l in ls:
        if l == 0:
            continue
        gate = torch.sigmoid(scal @ lp["gate_w"][l])  # (N, C)
        new[l] = feats[l] + out[l] * gate[..., None]
    return new


def forward_energy(params, batch: dict, cfg: NequIPConfig, *,
                   edge_chunk: int | None = None) -> torch.Tensor:
    """Per-graph energies (n_graphs,).

    batch: positions (N,3), edge_index (2,E), edge_mask (E,), node_mask (N,),
           graph_ids (N,), n_graphs int, and species (N,) int or
           node_feat (N, d_feat); tensors on one device.
    edge_chunk: at most this many edges of whole destination rows at a
           time in each block (None: all at once).
    """
    pos = batch["positions"]
    dev = pos.device
    n_nodes = pos.shape[0]
    node_mask = batch["node_mask"].to(pos.dtype)

    # Masked edges add exactly 0 (their path weights are 0) wherever they
    # point.  Padding such as the sampler's (0, 0) would pile them onto one
    # row, which B9 sums with one warp (and its gradient onto one source
    # row): edge e of them goes to node e mod N instead, as a self-loop.
    ei, keep = batch["edge_index"], batch["edge_mask"].bool()
    n_edges = ei.shape[1]
    spread = (torch.arange(n_edges, device=dev) % max(n_nodes, 1)).to(ei.dtype)
    src_in, dst_in = (torch.where(keep, x, spread) for x in (ei[0], ei[1]))
    del spread
    # edges sorted by destination, stably (B9's order; each row keeps its
    # edges' order, as segment_sum adds them)
    order = torch.argsort(dst_in, stable=True)
    src = src_in[order].to(torch.int32)
    dst = dst_in[order].to(torch.int32)
    mask = batch["edge_mask"][order].to(pos.dtype)
    del order, src_in, dst_in
    if edge_chunk is None:
        chunks = [(0, n_nodes, 0, n_edges)]
    else:
        off = _seg.row_offsets(dst, n_nodes).cpu().numpy().astype(np.int64)
        chunks = _edge_chunks(off, edge_chunk)
    ar = torch.arange(n_edges, dtype=torch.int32, device=dev)
    one = torch.ones(n_edges, dtype=torch.float32, device=dev)

    # initial features: scalar channels from species / continuous features
    if cfg.d_feat > 0:
        scal = batch["node_feat"].to(pos.dtype) @ params["embed"]
    else:
        scal = params["embed"][batch["species"].long()]
    c = cfg.d_hidden
    feats = {0: scal[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n_nodes, c, 2 * l + 1), dtype=pos.dtype,
                               device=dev)

    # edge geometry
    rel = _gather(pos, dst, ar, one) - _gather(pos, src, ar, one)   # (E, 3)
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-18)
    unit = rel / r[:, None]
    del rel
    sh = torch.cat(list(sph_harm_all(unit, cfg.l_max).values()), dim=1)
    del unit
    orders, g = _tp_plan(cfg.l_max)
    geo = {"src": src, "dst": dst, "mask": mask, "sh": sh, "ar": ar,
           "one": one, "rbf": bessel_rbf(r, cfg.n_rbf, cfg.cutoff),
           "orders": orders, "g": torch.tensor(g, device=dev)}
    del r

    for lp in params["layers"]:
        feats = _conv_layer(lp, feats, geo, cfg, chunks)

    h = F.silu(feats[0][..., 0] @ params["head_w1"] + params["head_b1"])
    e_atom = (h @ params["head_w2"])[..., 0] * node_mask  # (N,)
    # The indexed add sums in float64: over millions of atoms a float32
    # sum's rounding (~3e-5 relative at 2.4 M atoms, in an order that the
    # card's atomics change from run to run) would pass the energies' own
    # error.  The energies come back in float32.
    energies = torch.zeros(batch["n_graphs"], dtype=torch.float64, device=dev)
    energies = energies.index_add(0, batch["graph_ids"].long(),
                                  e_atom.to(torch.float64))
    return energies.to(e_atom.dtype)


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from (_leaves(v) if isinstance(v, (dict, list)) else (v,))


def forward_energy_forces(params, batch: dict, cfg: NequIPConfig, *,
                          edge_chunk: int | None = None):
    """(energies (G,), forces (N,3) = -dE/dpos).

    When a parameter requires a gradient the forces keep their graph
    (``create_graph``), so a force loss can be differentiated again;
    otherwise both come back detached."""
    train = any(p.requires_grad for p in _leaves(params))
    with torch.enable_grad():
        pos = batch["positions"].detach().requires_grad_(True)
        e = forward_energy(params, dict(batch, positions=pos), cfg,
                           edge_chunk=edge_chunk)
        (grad,) = torch.autograd.grad(e.sum(), pos, create_graph=train)
    return (e if train else e.detach()), -grad


def nequip_loss(params, batch: dict, cfg: NequIPConfig):
    """Energy + force MSE (standard NequIP objective)."""
    if cfg.force_loss_weight > 0:
        e, f = forward_energy_forces(params, batch, cfg)
        nm = batch["node_mask"].to(f.dtype)
        fl = torch.sum(torch.square(f - batch["forces"]) * nm[:, None]) \
            / torch.clamp(3 * nm.sum(), min=1)
    else:
        e = forward_energy(params, batch, cfg)
        fl = torch.zeros((), dtype=e.dtype, device=e.device)
    el = torch.mean(torch.square(e - batch["energies"]))
    loss = el + cfg.force_loss_weight * fl
    return loss, {"energy_mse": el, "force_mse": fl}


__all__ = ["NequIPConfig", "bessel_rbf", "forward_energy",
           "forward_energy_forces", "init_params", "nequip_loss",
           "param_shapes"]
