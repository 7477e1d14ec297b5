"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of ``repro.models.transformer.mla``.  The prefill decompresses
the latent per head; decode uses the absorbed form: queries are projected
into the latent space (q · W_uk), so attention runs against the compact
(kv_lora + rope) cache with no per-head K/V expansion.

The cast points are the reference's: scores are float32 sums of both
products (latent or no-position part, and the shared rope key), times
``(nope + rope)^-0.5``; masking by ``-1e30``; softmax in float32; the
weights cast to the activations' dtype before ``w·v``.  MLA attends in
plain PyTorch, as the reference does in plain jnp (its two head dims, 192
for q·k and 128 for v, are not the flash kernel's one).

The decode cache is written by index at ``lengths``, in place: the
reference adds ``one_hot(lengths) * new`` to a cache that is 0 there,
which gives the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)
from repro_torch.models.transformer.common import NEG, mm, past_length, rmsnorm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.kv_quant import quantize_kv, store_at
from repro_torch.models.transformer.rope import apply_rope, rope_cos_sin

F32 = torch.float32


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, T, kv_lora_rank)
    k_rope: torch.Tensor  # (B, T, qk_rope_head_dim)


def mla_qkv(p, x, cfg: TransformerConfig, positions):
    """Shared projections. Returns (q_nope, q_rope, c_kv, k_rope_pos)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    # Q: low-rank down, norm, up; split nope/rope per head.
    cq = rmsnorm(mm(x, p["wq_a"]), p["q_ln"], cfg.rms_eps)
    q = mm(cq, p["wq_b"]).reshape(
        b, s, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = q[..., m.qk_nope_head_dim:]
    # KV: joint down-projection; split latent / shared rope key.
    kv_a = mm(x, p["w_kv_a"])   # (B, S, kv_lora + rope)
    c_kv = rmsnorm(kv_a[..., :m.kv_lora_rank], p["kv_ln"], cfg.rms_eps)
    k_rope = kv_a[..., m.kv_lora_rank:]   # (B, S, rope) one shared head
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _scale(cfg):
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def mla_attention_train(p, x, cfg: TransformerConfig, positions,
                        return_latent: bool = False):
    """Full-sequence causal MLA (decompressed K/V, as the paper).

    Returns the block's output, and with ``return_latent`` also the
    latent ``c_kv`` and roped ``k_rope`` the decode cache holds.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = mla_qkv(p, x, cfg, positions)
    k_nope = torch.einsum("btr,rhn->bthn", c_kv, p["w_uk"].to(x.dtype))
    v = torch.einsum("btr,rhn->bthn", c_kv, p["w_uv"].to(x.dtype))

    scores = torch.einsum("bshn,bthn->bhst", q_nope.to(F32), k_nope.to(F32))
    scores += torch.einsum("bshr,btr->bhst", q_rope.to(F32), k_rope.to(F32))
    scores *= _scale(cfg)
    pos = torch.arange(s, device=x.device)
    scores.masked_fill_(pos[None, :] > pos[:, None], NEG)
    w = torch.softmax(scores, dim=-1)
    del scores
    w = w.to(x.dtype)
    ctx = torch.einsum("bhst,bthn->bshn", w, v)             # (B, S, H, vd)
    del w
    out = mm(ctx.reshape(b, s, h * m.v_head_dim), p["wo"])
    return (out, c_kv, k_rope) if return_latent else out


def _absorbed_query(p, x, q_nope):
    return torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"].to(x.dtype))


def _mask_len(scores, lengths):
    """Scores (B, H, 1, T) past the new token at ``lengths`` masked."""
    past = past_length(scores.shape[-1], lengths + 1)
    return scores.masked_fill(past[:, None, None, :], NEG)


def mla_attention_decode(p, x, cfg: TransformerConfig, cache: MLACache,
                         lengths: torch.Tensor):
    """One-token absorbed-MLA decode against the latent cache.

    x (B, 1, D); lengths (B,) the cache's fill.  The new token's latent is
    written into ``cache`` at ``lengths`` (in place); returns (out, cache).
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, c_new, kr_new = mla_qkv(p, x, cfg, lengths[:, None])
    store_at(cache.c_kv, c_new[:, 0], lengths)
    store_at(cache.k_rope, kr_new[:, 0], lengths)
    c_kv, k_rope = cache

    q_c = _absorbed_query(p, x, q_nope)                      # (B, 1, H, r)
    scores = (torch.einsum("bshr,btr->bhst", q_c.to(F32), c_kv.to(F32))
              + torch.einsum("bshr,btr->bhst", q_rope.to(F32),
                             k_rope.to(F32))) * _scale(cfg)
    w = torch.softmax(_mask_len(scores, lengths), dim=-1).to(x.dtype)
    ctx_c = torch.einsum("bhst,btr->bshr", w, c_kv.to(x.dtype))  # (B, 1, H, r)
    ctx = torch.einsum("bshr,rhn->bshn", ctx_c, p["w_uv"].to(x.dtype))
    out = mm(ctx.reshape(b, s, h * m.v_head_dim), p["wo"])
    return out, cache


def mla_attention_decode_quant(p, x, cfg: TransformerConfig, c_q, c_scale,
                               k_rope, lengths):
    """Absorbed MLA decode against an int8 latent cache.

    c_q (B, T, r) int8 with a per-(B, T) scale; the scale multiplies
    outside the products (the GQA int8 cache's scheme):
        score = (q_c . c_int8) * scale + q_rope . k_rope
        ctx_c = (p * scale) @ c_int8
    The new token is quantized and written at ``lengths`` (in place);
    returns (out, (c_q, c_scale, k_rope)).
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, c_new, kr_new = mla_qkv(p, x, cfg, lengths[:, None])
    cq_new, cs_new = quantize_kv(c_new[:, 0])                # (B, r), (B,)
    store_at(c_q, cq_new, lengths)
    store_at(c_scale, cs_new, lengths)
    store_at(k_rope, kr_new[:, 0], lengths)

    q_c = _absorbed_query(p, x, q_nope)
    scores = (torch.einsum("bshr,btr->bhst", q_c.to(F32), c_q.to(F32))
              * c_scale[:, None, None, :]
              + torch.einsum("bshr,btr->bhst", q_rope.to(F32),
                             k_rope.to(F32))) * _scale(cfg)
    w = torch.softmax(_mask_len(scores, lengths), dim=-1)
    pw = w * c_scale[:, None, None, :]                       # fold the scale
    ctx_c = torch.einsum("bhst,btr->bshr", pw, c_q.to(F32))
    ctx = torch.einsum("bshr,rhn->bshn", ctx_c.to(x.dtype), p["w_uv"].to(x.dtype))
    out = mm(ctx.reshape(b, s, h * m.v_head_dim), p["wo"])
    return out, (c_q, c_scale, k_rope)


def mla_shapes(cfg: TransformerConfig) -> dict:
    """Leaf name -> (shape, init scale; None for a ones vector) of one MLA
    layer, as the reference's ``mla_init``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq_a": ((d, m.q_lora_rank), d ** -0.5),
        "q_ln": ((m.q_lora_rank,), None),
        "wq_b": ((m.q_lora_rank,
                  h * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                 m.q_lora_rank ** -0.5),
        "w_kv_a": ((d, m.kv_lora_rank + m.qk_rope_head_dim), d ** -0.5),
        "kv_ln": ((m.kv_lora_rank,), None),
        "w_uk": ((m.kv_lora_rank, h, m.qk_nope_head_dim),
                 m.kv_lora_rank ** -0.5),
        "w_uv": ((m.kv_lora_rank, h, m.v_head_dim), m.kv_lora_rank ** -0.5),
        "wo": ((h * m.v_head_dim, d), (h * m.v_head_dim) ** -0.5),
    }
