"""GQA attention in plain PyTorch: dense, query-chunked and decode cases.

Grouped heads stay factored (B, S, Hkv, G, D), so K/V are never expanded to
Hq width.  Scores and the softmax are float32; ``p`` is cast to the inputs'
dtype before ``P·V``, whose sums are float32 and whose result is rounded to
the inputs' dtype, as the reference's mixed-precision einsums do.
"""

from __future__ import annotations

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)
from repro_torch.models.transformer.common import NEG


def _scores_softmax_ctx(q, k, v, mask, scale):
    """q (B,S,Hkv,G,D); k/v (B,T,Hkv,D); mask broadcastable (B,1,1,S,T)."""
    s = torch.einsum("bshgd,bthd->bhgst", q.to(torch.float32),
                     k.to(torch.float32))
    s = s * scale + mask
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhgst,bthd->bshgd", p.to(torch.float32),
                        v.to(torch.float32)).to(q.dtype)


def gqa_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, T, Hkv, D)
    v: torch.Tensor,  # (B, T, Hkv, D)
    *,
    causal: bool = True,
    q_offset: torch.Tensor | int = 0,      # absolute position of q[0]
    kv_len: torch.Tensor | None = None,    # (B,) valid cache length (decode)
    chunk: int = 0,
) -> torch.Tensor:
    """Returns (B, S, Hq, D).  fp32 softmax, inputs' dtype elsewhere."""
    b, s, hq, d = q.shape
    _, t, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, d)
    scale = torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32)
    dev = q.device
    k_pos = torch.arange(t, dtype=torch.int32, device=dev)

    def mask_for(q_pos):
        m = torch.zeros((b, 1, 1, q_pos.shape[0], t), dtype=torch.float32,
                        device=dev)
        neg = torch.full_like(m, NEG)
        if causal:
            m = torch.where(k_pos[None, None, None, None, :]
                            <= q_pos[None, None, None, :, None], m, neg)
        if kv_len is not None:
            m = torch.where(k_pos[None, None, None, None, :]
                            < kv_len[:, None, None, None, None], m, neg)
        return m

    if chunk and s > chunk and s % chunk == 0:
        # Query chunks in turn: score memory O(B·H·chunk·T).
        outs = []
        for idx in range(s // chunk):
            q_pos = q_offset + idx * chunk + torch.arange(
                chunk, dtype=torch.int32, device=dev)
            outs.append(_scores_softmax_ctx(
                qg[:, idx * chunk:(idx + 1) * chunk], k, v, mask_for(q_pos),
                scale))
        out = torch.cat(outs, dim=1)
    else:
        q_pos = q_offset + torch.arange(s, dtype=torch.int32, device=dev)
        out = _scores_softmax_ctx(qg, k, v, mask_for(q_pos), scale)
    return out.reshape(b, s, hq, d)
