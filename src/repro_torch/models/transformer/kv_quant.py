"""int8 KV cache for decode: symmetric per-(token, head) quantization.

The port of ``repro.models.transformer.kv_quant``.  Each cached K/V row is
stored as int8 with one float32 scale (its amax / 127), and the scale
multiplies outside the products:

    scores[t] = (q . k_int8[t]) * k_scale[t]
    out       = sum_t (p[t] * v_scale[t]) . v_int8[t]

so attention reads int8 payloads and rank-1 scales.  The products run in
float32 on the int8 values cast to float32, as the reference's do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)
from repro_torch.device import resolve_device
from repro_torch.models.transformer.common import NEG, past_length


class QuantKVCache(NamedTuple):
    """GQA decode cache with int8 payloads + per-(B,T,H) scales."""
    k_q: torch.Tensor       # (L, B, T, Hkv, dh) int8
    k_scale: torch.Tensor   # (L, B, T, Hkv) f32
    v_q: torch.Tensor       # (L, B, T, Hkv, dh) int8
    v_scale: torch.Tensor   # (L, B, T, Hkv) f32
    lengths: torch.Tensor   # (B,)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., dh) float -> (int8 (..., dh), scale (...,) f32).

    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def store_at(cache: torch.Tensor, new: torch.Tensor,
             lengths: torch.Tensor) -> None:
    """cache (B, T, ...)[b, lengths[b]] = new (B, ...), in place.  The
    reference adds ``one_hot(lengths) * new`` to a cache that is 0 there;
    the indexed store gives the same values."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, lengths.long()] = new.to(cache.dtype)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def init_quant_cache(cfg, batch: int, max_len: int, *,
                     device=None) -> QuantKVCache:
    dev = resolve_device(device)
    l, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.d_head
    return QuantKVCache(
        k_q=torch.zeros((l, batch, max_len, hkv, dh), dtype=torch.int8,
                        device=dev),
        k_scale=torch.zeros((l, batch, max_len, hkv), dtype=torch.float32,
                            device=dev),
        v_q=torch.zeros((l, batch, max_len, hkv, dh), dtype=torch.int8,
                        device=dev),
        v_scale=torch.zeros((l, batch, max_len, hkv), dtype=torch.float32,
                            device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def quant_attention_decode(
    q: torch.Tensor,          # (B, 1, Hq, dh) float
    k_q: torch.Tensor,        # (B, T, Hkv, dh) int8
    k_scale: torch.Tensor,    # (B, T, Hkv) f32
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    lengths: torch.Tensor,    # (B,)
) -> torch.Tensor:
    """One-token attention against the int8 cache; scales factored out of
    the products.  Returns (B, 1, Hq, dh) float32."""
    b, s, hq, dh = q.shape
    _, t, hkv, _ = k_q.shape
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, dh).to(torch.float32)
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k_q.to(torch.float32))
    scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = scores * (1.0 / dh ** 0.5)
    past = past_length(t, lengths)
    scores = scores.masked_fill(past[:, None, None, None, :], NEG)
    p = torch.softmax(scores, dim=-1)
    # fold v_scale into the probabilities (rank-1), then one product
    pv = p * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgst,bthd->bshgd", pv, v_q.to(torch.float32))
    return out.reshape(b, s, hq, dh)


class QuantMLACache(NamedTuple):
    """MLA latent cache with int8 c_kv (+ per-(B,T) scale); k_rope stays
    float (qk_rope_head_dim values a token, small beside kv_lora_rank)."""
    c_q: torch.Tensor       # (L, B, T, r) int8
    c_scale: torch.Tensor   # (L, B, T) f32
    k_rope: torch.Tensor    # (L, B, T, dr) float
    lengths: torch.Tensor   # (B,)


def init_quant_mla_cache(cfg, batch: int, max_len: int,
                         dtype=torch.bfloat16, *,
                         device=None) -> QuantMLACache:
    dev = resolve_device(device)
    l, m = cfg.n_layers, cfg.mla
    return QuantMLACache(
        c_q=torch.zeros((l, batch, max_len, m.kv_lora_rank), dtype=torch.int8,
                        device=dev),
        c_scale=torch.zeros((l, batch, max_len), dtype=torch.float32,
                            device=dev),
        k_rope=torch.zeros((l, batch, max_len, m.qk_rope_head_dim),
                           dtype=dtype, device=dev),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )
