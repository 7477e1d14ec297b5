"""Dense GQA transformer: init, forward, batched prefill and decode.

The port of ``repro.models.transformer.model`` for dense GQA
configurations (no MLA, no MoE: building one raises, ROADMAP A13).
Parameters are a plain dict shaped like the reference's pytree: the layer
weights stacked along a leading ``n_layers`` axis, layer ``i`` read as a
view.  The cast points are the reference's: each weight is cast to the
activations' dtype at its product, ``rmsnorm`` computes in float32, and the
logits are the float32 cast of ``x @ unembed.T``.

One change of implementation: the causal self-attention of the prefill
and forward runs kernel B8 (``kernels/flash_attention.py``), which computes
the same function as the reference's ``gqa_attention(causal=True)`` with
the flash kernel's roundings; on CPU tensors that is B8's plain version.
Decode attends with the plain ``gqa_attention`` (``causal=False``,
``kv_len``), as the reference does outside any kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.transformer.attention import gqa_attention
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.rope import apply_rope, rope_cos_sin


class KVCache(NamedTuple):
    """Decode cache: k/v (L, B, T, Hkv, dh); lengths (B,) tokens in cache."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


def require_dense_gqa(cfg: TransformerConfig) -> None:
    """Raise unless ``cfg`` is a dense GQA model, the only kind ported."""
    if cfg.attention != "gqa" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention and MoE layers are not ported yet "
            "(ROADMAP A13); the port builds dense GQA models")


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator``, shaped and scaled
    as the reference's ``init_params`` (its numbers differ: JAX's generator
    is not PyTorch's; carry the reference's weights with
    ``convert.transformer_params_from_numpy`` to compare the two)."""
    require_dense_gqa(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    d, l, hq, hkv, dh = (cfg.d_model, cfg.n_layers, cfg.n_heads,
                         cfg.n_kv_heads, cfg.d_head)

    def normal(shape, scale):
        x = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        return x.mul_(scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    attn = {
        "wq": normal((l, d, hq * dh), d ** -0.5),
        "wk": normal((l, d, hkv * dh), d ** -0.5),
        "wv": normal((l, d, hkv * dh), d ** -0.5),
        "wo": normal((l, hq * dh, d), (hq * dh) ** -0.5),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            attn[name] = torch.zeros((l, width), device=dev, dtype=dtype)
    params = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5),
        "final_ln": ones((d,)),
        "layers": {
            "ln1": ones((l, d)),
            "attn": attn,
            "ln2": ones((l, d)),
            "ffn": {
                "w_gate": normal((l, d, cfg.d_ff), d ** -0.5),
                "w_in": normal((l, d, cfg.d_ff), d ** -0.5),
                "w_out": normal((l, cfg.d_ff, d), cfg.d_ff ** -0.5),
            },
        },
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.vocab_size, d), d ** -0.5)
    return params


# ---------------------------------------------------------------------------
# forward (scoring) and batched prefill
# ---------------------------------------------------------------------------
def _gqa_block_train(cfg, p, h, positions):
    """Causal self-attention of one block; returns (out, k, v), k roped."""
    b, s, _ = h.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _mm(h, p["wq"]), _mm(h, p["wk"]), _mm(h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(h.dtype)
        k = k + p["bk"].to(h.dtype)
        v = v + p["bv"].to(h.dtype)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention(q, k, v, causal=True)
    return _mm(out.reshape(b, s, hq * dh), p["wo"]), k, v


def _dense_ffn(p, h):
    gate = _mm(h, p["w_gate"])
    return _mm(gate * torch.sigmoid(gate) * _mm(h, p["w_in"]), p["w_out"])


def _block_train(cfg, lp, x, positions):
    """One block; returns (x, k, v) with the block's K/V for the cache."""
    h = rmsnorm(x, lp["ln1"], cfg.rms_eps)
    a, k, v = _gqa_block_train(cfg, lp["attn"], h, positions)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.rms_eps)
    return x + _dense_ffn(lp["ffn"], h), k, v


def _logits(params, x, cfg):
    x = rmsnorm(x, params["final_ln"], cfg.rms_eps)
    unembed = params.get("unembed", params["embed"])
    return (x @ unembed.to(x.dtype).T).to(torch.float32)


def _prefill(params, tokens, cfg, on_layer=None):
    require_dense_gqa(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    for i in range(cfg.n_layers):
        x, k, v = _block_train(cfg, _layer(params["layers"], i), x, positions)
        if on_layer is not None:
            on_layer(i, k, v)
    return _logits(params, x, cfg)


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V) f32, aux_loss 0 (no MoE))."""
    logits = _prefill(params, tokens, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def forward_with_cache(params, tokens: torch.Tensor, cfg: TransformerConfig,
                       max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Batched prefill: the causal forward that also fills the KV cache.

    tokens (B,S) -> (logits (B,S,V) f32, cache of max_len positions, the
    first S filled, the rest 0).  ``prefill`` is the sequential reference.
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)

    def store(i, k, v):
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v

    logits = _prefill(params, tokens, cfg, store)
    cache.lengths.fill_(s)
    return logits, cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> KVCache:
    require_dense_gqa(cfg)
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros((batch,), dtype=torch.int32, device=dev))


def _gqa_block_decode(cfg, p, x, k_cache, v_cache, lengths):
    """x (B,1,D); k/v_cache (B,T,Hkv,dh), written in place at ``lengths``."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _mm(x, p["wq"]), _mm(x, p["wk"]), _mm(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    cos, sin = rope_cos_sin(lengths[:, None], dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # The reference adds one_hot(lengths) * k to a cache that is 0 there;
    # the indexed store gives the same values.
    rows = torch.arange(b, device=x.device)
    pos = lengths.long()
    k_cache[rows, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, pos] = v[:, 0].to(v_cache.dtype)
    out = gqa_attention(q, k_cache, v_cache, causal=False, kv_len=lengths + 1)
    return _mm(out.reshape(b, s, hq * dh), p["wo"])


def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                cfg: TransformerConfig) -> tuple[torch.Tensor, KVCache]:
    """One decode step: tokens (B,1) -> (logits (B,1,V) f32, cache).

    The cache's K/V tensors are updated in place (the returned cache shares
    them, with ``lengths + 1``): a caller that needs the old cache clones it.
    """
    require_dense_gqa(cfg)
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    lengths = cache.lengths
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rmsnorm(x, lp["ln1"], cfg.rms_eps)
        x = x + _gqa_block_decode(cfg, lp["attn"], h, cache.k[i], cache.v[i],
                                  lengths)
        h = rmsnorm(x, lp["ln2"], cfg.rms_eps)
        x = x + _dense_ffn(lp["ffn"], h)
    return _logits(params, x, cfg), KVCache(cache.k, cache.v, lengths + 1)


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Sequential-decode prefill (the clarity-first reference)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    logits = None
    for i in range(s):
        logits, cache = decode_step(params, cache, tokens[:, i:i + 1], cfg)
    return logits, cache
