"""Plain-PyTorch oracles of the phase-1, phase-2, quadratic-RWMD, attention
and gather-scale-scatter kernels.

Counterparts of ``repro.kernels.ref``: the semantic ground truth, written
independently of the kernels' own plain versions (gather from the table,
materialize the (v, B·h) distance matrix, sqrt in the oracle).
"""

from __future__ import annotations

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)


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


def rwmd_pairwise_ref(t1: torch.Tensor, w1: torch.Tensor, t2: torch.Tensor,
                      w2: torch.Tensor) -> torch.Tensor:
    """Symmetric quadratic RWMD of a tile of docs vs ONE query.

    t1: (n, h1, m) resident word embeddings; w1: (n, h1) weights (0 = pad);
    t2: (h2, m) query embeddings; w2: (h2,).
    Returns (n,) f32: max(d12, d21) per resident doc.
    """
    t1 = t1.to(torch.float32)
    t2 = t2.to(torch.float32)
    a2 = (t1 * t1).sum(dim=-1)                       # (n, h1)
    b2 = (t2 * t2).sum(dim=-1)                       # (h2,)
    ab = torch.einsum("nhm,qm->nhq", t1, t2)
    c = torch.sqrt(torch.clamp(a2[..., None] + b2[None, None, :] - 2.0 * ab,
                               min=0.0))             # (n, h1, h2)
    m1 = w1 > 0
    m2 = w2 > 0
    inf = torch.tensor(float("inf"))
    row_min = torch.where(m2[None, None, :], c, inf).amin(dim=2)   # (n, h1)
    d12 = (w1 * torch.where(m1, row_min, 0.0)).sum(dim=1)
    col_min = torch.where(m1[..., None], c, inf).amin(dim=1)       # (n, h2)
    d21 = col_min @ torch.where(m2, w2, 0.0)
    return torch.maximum(d12, d21)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Plain masked-softmax GQA attention oracle.

    q (B, S, Hq, D); k/v (B, T, Hkv, D); query head h reads KV head
    ``h // (Hq // Hkv)``.  Returns (B, S, Hq, D) in q's dtype.
    """
    b, sq, hq, d = q.shape
    _, t, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).to(torch.float32)
    s_ = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32))
    s_ = s_ / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    if causal:
        keep = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s_ = torch.where(keep, s_, torch.full_like(s_, -1e30))
    p = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhgst,bthd->bshgd", p, v.to(torch.float32))
    return o.reshape(b, sq, hq, d).to(q.dtype)


def segment_spmm_ref(src: torch.Tensor, dst: torch.Tensor, feat: torch.Tensor,
                     rad: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[n] = Σ_{e: dst[e] = n} rad[e] · feat[src[e]] (any edge order)."""
    msg = rad.to(torch.float32)[:, None] * feat.to(torch.float32)[src.long()]
    out = torch.zeros((n_out, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    return out.index_add_(0, dst.long(), msg)
