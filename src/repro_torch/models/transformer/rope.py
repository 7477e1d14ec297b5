"""Rotary position embeddings (RoPE), llama-style rotate-half convention."""

from __future__ import annotations

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)


def rope_cos_sin(positions: torch.Tensor, dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> cos/sin (..., S, dim/2) f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv  # (..., S, dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with cos/sin (..., S, D/2); rotates in f32."""
    dtype = x.dtype
    x = x.to(torch.float32)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dtype)
