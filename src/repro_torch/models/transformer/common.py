"""Leaf helpers shared by the transformer's modules (``model``, ``mla``,
``kv_quant``, ``attention``): RMSNorm in float32, the product that casts
its weight to the activations' dtype, and the attention masks' value."""

from __future__ import annotations

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)

NEG = -1e30   # a masked score: exp underflows to 0 in float32


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w, the weight cast to x's dtype at the product."""
    return x @ w.to(x.dtype)


def past_length(t: int, n_valid: torch.Tensor) -> torch.Tensor:
    """(B, t) bool: key position >= ``n_valid`` (B,), the cache's unfilled
    slots that a decode step masks."""
    k_pos = torch.arange(t, dtype=torch.int32, device=n_valid.device)
    return k_pos[None, :] >= n_valid[:, None]
