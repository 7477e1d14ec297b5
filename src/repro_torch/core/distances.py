"""Pairwise Euclidean-distance primitives (the paper's `∘` operator).

``‖a−b‖² = ‖a‖² + ‖b‖² − 2·a·b``: the cubic middle term is a plain float32
GEMM (``torch.matmul``, as the reference leaves it to XLA outside its
kernels).  ``bf16_matmul=True`` rounds the GEMM operands to bf16 and keeps
the product and the norms in float32.
"""

from __future__ import annotations

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)


def _require_ieee_f32() -> None:
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled; the port's float32 GEMMs must run in IEEE "
            "float32 (set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.backends.cudnn.allow_tf32 = False)")


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest bf16 (round-to-nearest-even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def sq_dists(a: torch.Tensor, b: torch.Tensor, *,
             bf16_matmul: bool = False) -> torch.Tensor:
    """Squared Euclidean distances between rows of ``a`` (p,m) and ``b`` (q,m).

    Returns (p, q) float32, clamped at 0.
    """
    _require_ieee_f32()
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = (a * a).sum(dim=-1)[:, None]
    b2 = (b * b).sum(dim=-1)[None, :]
    if bf16_matmul:
        ab = torch.matmul(bf16_round(a), bf16_round(b).T)
    else:
        ab = torch.matmul(a, b.T)
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def pair_dists(a: torch.Tensor, b: torch.Tensor, *,
               bf16_matmul: bool = False) -> torch.Tensor:
    """Euclidean distances per pair: a (P, p, m), b (P, q, m) → (P, p, q).

    The batched form of :func:`dists` (the reference maps ``dists`` over
    the pairs axis); safe sqrt.
    """
    _require_ieee_f32()
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a2 = (a * a).sum(dim=-1)[:, :, None]
    b2 = (b * b).sum(dim=-1)[:, None, :]
    if bf16_matmul:
        ab = torch.bmm(bf16_round(a), bf16_round(b).transpose(1, 2))
    else:
        ab = torch.bmm(a, b.transpose(1, 2))
    return safe_sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))


def dists(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """Euclidean distances between rows of ``a`` and ``b``; safe sqrt."""
    return safe_sqrt(sq_dists(a, b, **kw))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero-safe gradient (d/dx sqrt at 0 is inf otherwise)."""
    return torch.sqrt(torch.clamp(x, min=1e-12)) * (x > 0)
