"""Plain-PyTorch oracles of the phase-1 and phase-2 kernels.

Counterparts of ``repro.kernels.ref``: the semantic ground truth, written
independently of the kernels' own plain versions (gather from the table,
materialize the (v, B·h) distance matrix, sqrt in the oracle).
"""

from __future__ import annotations

import torch


def lc_rwmd_phase1_ref(emb: torch.Tensor, q_ids: torch.Tensor,
                       q_w: torch.Tensor) -> torch.Tensor:
    """Z[w, j] = min over valid words q of query j of ||E[w] - E[q]||.

    emb: (v, m) f32; q_ids: (B, h) int; q_w: (B, h) f32 (0 = padding).
    Returns (v, B) f32.
    """
    emb = emb.to(torch.float32)
    b, h = q_ids.shape
    t = emb[q_ids.reshape(-1).long()]  # (B*h, m)
    e2 = (emb * emb).sum(dim=-1)[:, None]
    t2 = (t * t).sum(dim=-1)[None, :]
    sq = torch.clamp(e2 + t2 - 2.0 * (emb @ t.T), min=0.0)  # (v, B*h)
    sq = torch.where((q_w > 0).reshape(1, -1), sq,
                     torch.full_like(sq, float("inf")))
    z = sq.reshape(-1, b, h).amin(dim=2)  # (v, B)
    return torch.sqrt(torch.clamp(z, min=0.0))


def spmm_ell_ref(ids: torch.Tensor, w: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """D[i, j] = Σ_p w[i,p] · Z[ids[i,p], j].  ids/w (n, h); z (v, B) → (n, B)."""
    return torch.einsum("nh,nhb->nb", w.to(torch.float32),
                        z[ids.long()].to(torch.float32))
