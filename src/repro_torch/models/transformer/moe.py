"""Mixture-of-Experts FFN: GShard-style grouped dispatch + shared experts.

The port of ``repro.models.transformer.moe``, with its semantics: tokens in
groups of ``min(1024, n)`` (G, group, D) with a per-group capacity
``C = ceil(top_k * group / E * capacity_factor)``; routing logits in
float32, softmax, the top-k renormalised (ties to the lower expert index,
as ``jax.lax.top_k``: a stable sort); each chosen expert's slot by a
running count over the group, choice slot 0 before slot 1, tokens in
order; (token, choice) pairs past the capacity are dropped (combine
weight 0, the residual carries them); the Switch load-balancing loss; the
shared experts added after the combine.

One change of implementation: the reference dispatches and combines with
dense (G, group, E, C) one-hot einsums; here each kept pair is scattered
into its (expert, slot) row and gathered back by index.  A slot holds one
token, so the dispatched rows are the reference's exactly; the combine
weights are rounded to the activations' dtype before the combine, as the
reference rounds them, and a token's k products are summed in float32.
"""

from __future__ import annotations

import math

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)
from repro_torch.models.transformer.config import MoEConfig

GROUP_SIZE = 1024


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(x, w_gate, w_in, w_out):
    """silu(x W_gate) * (x W_in) W_out, each weight cast to x's dtype."""
    ct = lambda w: w.to(x.dtype)  # noqa: E731
    return (_silu(x @ ct(w_gate)) * (x @ ct(w_in))) @ ct(w_out)


def route(xt: torch.Tensor, router: torch.Tensor, moe: MoEConfig):
    """The router of groups ``xt`` (G, n, D): (probs (G, n, E) f32, top
    weights (G, n, k) f32 renormalised, top experts (G, n, k) int64)."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index first
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :moe.top_k], top_i[..., :moe.top_k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def slots(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (token, choice)'s slot in its expert (G, n, k): a running count
    over the group, all tokens' choice 0 first, then choice 1, ..."""
    g, n, k = top_i.shape
    order = top_i.transpose(1, 2).reshape(g, k * n)               # slot-major
    onehot = torch.nn.functional.one_hot(order, n_experts).to(torch.int32)
    pos = onehot.cumsum(dim=1).gather(2, order[..., None])[..., 0] - 1
    return pos.reshape(g, k, n).transpose(1, 2)


def capacity(moe: MoEConfig, group: int) -> int:
    return max(int(math.ceil(moe.top_k * group / moe.n_experts
                             * moe.capacity_factor)), 1)


def moe_ffn(p: dict, x: torch.Tensor, moe: MoEConfig, *,
            group_size: int = GROUP_SIZE, dtype=torch.bfloat16
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar f32)."""
    b, s, d = x.shape
    n = b * s
    e, k = moe.n_experts, moe.top_k
    gsz = min(group_size, n)
    if n % gsz:
        raise ValueError(
            f"{n} tokens do not make whole groups of {gsz}: the reference's "
            "grouped dispatch takes a multiple of its group size (no padding)")
    g = n // gsz
    cap = capacity(moe, gsz)
    xt = x.reshape(g, gsz, d)

    # --- routing and the aux load-balance loss (Switch): E * sum_e f_e P_e
    probs, top_p, top_i = route(xt, p["router"], moe)
    me = probs.mean(dim=1)                                            # (G, E)
    counts = torch.zeros((g, e), dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, top_i.reshape(g, gsz * k),
                        torch.ones((g, gsz * k), dtype=torch.float32,
                                   device=x.device))
    aux = moe.aux_loss_weight * e * (me * (counts / gsz)).sum(dim=-1).mean()

    # --- capacity slots; overflowed pairs dropped --------------------------
    pos = slots(top_i, e)                                             # (G, n, k)
    keep = pos < cap

    # --- dispatch: each kept pair's token into its (expert, slot) row ------
    # Dropped pairs all go to one spare row past the last slot, so the
    # scatter needs no count of the kept pairs (no host sync).
    rows = g * e * cap
    gi = torch.arange(g, device=x.device)[:, None, None]
    row = torch.where(keep, (gi * e + top_i) * cap + pos, rows)       # (G, n, k)
    xe = torch.zeros((rows + 1, d), dtype=dtype, device=x.device)
    xe.index_put_((row.reshape(-1),),
                  xt.to(dtype)[:, :, None, :].expand(g, gsz, k, d).reshape(-1, d))
    xe = xe[:rows].reshape(g, e, cap, d)

    # --- expert compute ----------------------------------------------------
    ct = lambda w: w.to(dtype)  # noqa: E731
    h = _silu(torch.einsum("gecd,edf->gecf", xe, ct(p["w_experts_gate"]))) \
        * torch.einsum("gecd,edf->gecf", xe, ct(p["w_experts_in"]))
    ye = torch.einsum("gecf,efd->gecd", h, ct(p["w_experts_out"]))
    del h

    # --- combine: a token's kept products, weights rounded to dtype --------
    comb = torch.where(keep, top_p, 0.0).to(dtype).to(torch.float32)  # (G, n, k)
    picked = ye.reshape(rows, d)[row.clamp(max=rows - 1)].to(torch.float32)
    picked = torch.where(keep[..., None], picked, 0.0)                # (G, n, k, D)
    out = torch.einsum("gnk,gnkd->gnd", comb, picked).to(dtype)
    del picked

    # --- shared (always-on) experts ----------------------------------------
    if moe.n_shared > 0:
        out = out + swiglu(xt, p["w_shared_gate"], p["w_shared_in"],
                            p["w_shared_out"])
    return out.reshape(b, s, d), aux


def moe_shapes(d_model: int, moe: MoEConfig) -> dict:
    """Leaf name -> (shape, init scale) of one MoE layer, as ``moe_init``."""
    e, f = moe.n_experts, moe.d_expert_ff
    shapes = {
        "router": ((d_model, e), d_model ** -0.5),
        "w_experts_gate": ((e, d_model, f), d_model ** -0.5),
        "w_experts_in": ((e, d_model, f), d_model ** -0.5),
        "w_experts_out": ((e, f, d_model), f ** -0.5),
    }
    if moe.n_shared > 0:
        fs = moe.n_shared * f
        shapes.update({
            "w_shared_gate": ((d_model, fs), d_model ** -0.5),
            "w_shared_in": ((d_model, fs), d_model ** -0.5),
            "w_shared_out": ((fs, d_model), fs ** -0.5),
        })
    return shapes
