"""Transformer: init, forward, batched prefill and decode (fp and int8).

The port of ``repro.models.transformer.model``'s serving path for every
registered LM: dense GQA, MLA attention (``mla.py``) and MoE FFNs
(``moe.py``), with the reference's ``prefix_layers`` (deepseek-v2's
leading dense layer) before the stacked layers.  Parameters are a plain
dict shaped like the reference's pytree: the stacked layers' weights along
a leading axis, layer ``i`` read as a view, and ``prefix_layers`` a list
of one dict a layer.  The cast points are the reference's: each weight is
cast to the activations' dtype at its product, ``rmsnorm`` computes in
float32, and the logits are the float32 cast of ``x @ unembed.T``.

One change of implementation: the causal self-attention of a GQA prefill
and forward runs kernel B8 (``kernels/flash_attention.py``), which
computes the same function as the reference's ``gqa_attention(causal=True)``
with the flash kernel's roundings; on CPU tensors that is B8's plain
version.  Decode attends with the plain ``gqa_attention`` (``causal=False``,
``kv_len``), and MLA and MoE in plain PyTorch, as the reference does
outside any kernel.  Caches are updated in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.transformer.attention import gqa_attention
from repro_torch.models.transformer.common import mm, rmsnorm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.models.transformer.kv_quant import (
    QuantKVCache,
    quant_attention_decode,
    quantize_kv,
    store_at,
)
from repro_torch.models.transformer.mla import (
    MLACache,
    mla_attention_decode,
    mla_attention_train,
    mla_shapes,
)
from repro_torch.models.transformer.moe import moe_ffn, moe_shapes, swiglu
from repro_torch.models.transformer.rope import apply_rope, rope_cos_sin

# Elements of float32 a seeded draw makes at once: the transient of one
# stacked expert tensor (grok-1's w_experts_gate is 12.9 GB in float32 for
# two layers) stays under 1 GB.
INIT_CHUNK = 1 << 28


class KVCache(NamedTuple):
    """Decode cache.  GQA: k/v (L, B, T, Hkv, dh).  MLA: k = c_kv
    (L, B, T, r), v = k_rope (L, B, T, dr).  lengths (B,) tokens in cache."""
    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("float32", "bfloat16")."""
    return getattr(torch, name)


def n_prefix(cfg: TransformerConfig) -> int:
    """Leading dense layers kept apart from the stacked ones."""
    return cfg.moe.first_dense_layers if cfg.moe else 0


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def _layers(params: dict, cfg: TransformerConfig):
    """(cache index, layer params, dense) of every layer, prefix first."""
    pre = params.get("prefix_layers", [])
    for i, lp in enumerate(pre):
        yield i, lp, True
    for i in range(cfg.n_layers - len(pre)):
        yield len(pre) + i, _layer(params["layers"], i), False


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: TransformerConfig, dense: bool) -> dict:
    """Leaf shapes and init scales (None: ones, 0.0: zeros) of one layer."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if cfg.attention == "gqa":
        attn = {
            "wq": ((d, hq * dh), d ** -0.5),
            "wk": ((d, hkv * dh), d ** -0.5),
            "wv": ((d, hkv * dh), d ** -0.5),
            "wo": ((hq * dh, d), (hq * dh) ** -0.5),
        }
        if cfg.qkv_bias:
            for name, width in (("bq", hq * dh), ("bk", hkv * dh),
                                ("bv", hkv * dh)):
                attn[name] = ((width,), 0.0)
    else:
        attn = mla_shapes(cfg)
    if dense or cfg.moe is None:
        ffn = {"w_gate": ((d, cfg.d_ff), d ** -0.5),
               "w_in": ((d, cfg.d_ff), d ** -0.5),
               "w_out": ((cfg.d_ff, d), cfg.d_ff ** -0.5)}
    else:
        ffn = moe_shapes(d, cfg.moe)
    return {"ln1": ((d,), None), "attn": attn, "ln2": ((d,), None),
            "ffn": ffn}


def init_params(cfg: TransformerConfig, *, seed: int = 0,
                device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator``, shaped and scaled
    as the reference's ``init_params`` (its numbers differ: JAX's generator
    is not PyTorch's; carry the reference's weights with
    ``convert.transformer_params_from_numpy`` to compare the two).  Each
    tensor is drawn ``INIT_CHUNK`` float32 values at a time, straight into
    the parameter dtype.  On the ``"meta"`` device the tensors have shapes
    and no values (a full-size configuration's layout, at no cost)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    meta = dev.type == "meta"
    g = None if meta else torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def make(shape, scale):
        if scale is None:
            return torch.ones(shape, device=dev, dtype=dtype)
        out = torch.zeros(shape, device=dev, dtype=dtype)
        if scale == 0.0 or meta:
            return out
        flat = out.view(-1)
        for lo in range(0, flat.numel(), INIT_CHUNK):
            hi = min(lo + INIT_CHUNK, flat.numel())
            x = torch.randn(hi - lo, generator=g, device=dev,
                            dtype=torch.float32)
            flat[lo:hi] = x.mul_(scale)
        return out

    def build(tree, lead=()):
        return {k: build(v, lead) if isinstance(v, dict)
                else make(lead + v[0], v[1]) for k, v in tree.items()}

    npre = n_prefix(cfg)
    params = {"embed": make((cfg.vocab_size, d), d ** -0.5),
              "final_ln": make((d,), None)}
    if npre:
        params["prefix_layers"] = [build(_layer_shapes(cfg, True))
                                   for _ in range(npre)]
    params["layers"] = build(_layer_shapes(cfg, False),
                             (cfg.n_layers - npre,))
    if not cfg.tie_embeddings:
        params["unembed"] = make((cfg.vocab_size, d), d ** -0.5)
    return params


# ---------------------------------------------------------------------------
# forward (scoring) and batched prefill
# ---------------------------------------------------------------------------
def _qkv(cfg, p, x, positions):
    """Roped q (B,S,Hq,dh), roped k and v (B,S,Hkv,dh) of a GQA block."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = mm(x, p["wq"]), mm(x, p["wk"]), mm(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    cos, sin = rope_cos_sin(positions, dh, cfg.rope_theta)
    return (apply_rope(q.reshape(b, s, hq, dh), cos, sin),
            apply_rope(k.reshape(b, s, hkv, dh), cos, sin),
            v.reshape(b, s, hkv, dh))


def _gqa_block_train(cfg, p, h, positions):
    """Causal self-attention of one block; returns (out, k, v), k roped."""
    b, s, _ = h.shape
    q, k, v = _qkv(cfg, p, h, positions)
    out = flash_attention(q, k, v, causal=True)
    return mm(out.reshape(b, s, cfg.n_heads * cfg.d_head), p["wo"]), k, v


def _dense_ffn(p, h):
    return swiglu(h, p["w_gate"], p["w_in"], p["w_out"])


def _block_train(cfg, lp, x, positions, *, dense: bool):
    """One block: (x, aux, k, v), with the block's cache entries: GQA's
    roped K and V, MLA's latent ``c_kv`` and roped ``k_rope``."""
    h = rmsnorm(x, lp["ln1"], cfg.rms_eps)
    if cfg.attention == "gqa":
        a, k, v = _gqa_block_train(cfg, lp["attn"], h, positions)
    else:
        a, k, v = mla_attention_train(lp["attn"], h, cfg, positions,
                                      return_latent=True)
    x = x + a
    h = rmsnorm(x, lp["ln2"], cfg.rms_eps)
    if dense or cfg.moe is None:
        return x + _dense_ffn(lp["ffn"], h), None, k, v
    f, aux = moe_ffn(lp["ffn"], h, cfg.moe, dtype=h.dtype)
    return x + f, aux, k, v


def _logits(params, x, cfg):
    x = rmsnorm(x, params["final_ln"], cfg.rms_eps)
    unembed = params.get("unembed", params["embed"])
    return (x @ unembed.to(x.dtype).T).to(torch.float32)


def _prefill(params, tokens, cfg, on_layer=None):
    """(logits, aux summed over the layers); ``on_layer(i, k, v)`` gets
    each layer's cache entries, prefix layers first."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None, :].expand(b, s)
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i, lp, dense in _layers(params, cfg):
        x, aux, k, v = _block_train(cfg, lp, x, positions, dense=dense)
        if aux is not None:
            aux_total = aux_total + aux
        if on_layer is not None:
            on_layer(i, k, v)
    return _logits(params, x, cfg), aux_total


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> (logits (B,S,V) f32, aux_loss scalar f32)."""
    return _prefill(params, tokens, cfg)


def forward_with_cache(params, tokens: torch.Tensor, cfg: TransformerConfig,
                       max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Batched prefill: the causal forward that also fills the cache.

    tokens (B,S) -> (logits (B,S,V) f32, cache of max_len positions, the
    first S filled, the rest 0; MLA caches the latent).  ``prefill`` is the
    sequential reference.
    """
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)

    def store(i, k, v):
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v

    logits, _ = _prefill(params, tokens, cfg, store)
    cache.lengths.fill_(s)
    return logits, cache


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------
def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> KVCache:
    dev = resolve_device(device)
    dtype = dtype or dtype_of(cfg.dtype)
    l = cfg.n_layers  # prefix layers included in the same stacked cache
    if cfg.attention == "gqa":
        shape_k = shape_v = (l, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    else:
        shape_k = (l, batch, max_len, cfg.mla.kv_lora_rank)
        shape_v = (l, batch, max_len, cfg.mla.qk_rope_head_dim)
    return KVCache(k=torch.zeros(shape_k, dtype=dtype, device=dev),
                   v=torch.zeros(shape_v, dtype=dtype, device=dev),
                   lengths=torch.zeros((batch,), dtype=torch.int32, device=dev))


def _gqa_block_decode(cfg, p, x, k_cache, v_cache, lengths):
    """x (B,1,D); k/v_cache (B,T,Hkv,dh), written in place at ``lengths``."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, lengths[:, None])
    store_at(k_cache, k[:, 0], lengths)
    store_at(v_cache, v[:, 0], lengths)
    out = gqa_attention(q, k_cache, v_cache, causal=False, kv_len=lengths + 1)
    return mm(out.reshape(b, s, cfg.n_heads * cfg.d_head), p["wo"])


def _ffn(cfg, lp, h, dense: bool):
    if dense or cfg.moe is None:
        return _dense_ffn(lp["ffn"], h)
    return moe_ffn(lp["ffn"], h, cfg.moe, dtype=h.dtype)[0]


def decode_step(params, cache: KVCache, tokens: torch.Tensor,
                cfg: TransformerConfig) -> tuple[torch.Tensor, KVCache]:
    """One decode step: tokens (B,1) -> (logits (B,1,V) f32, cache).

    The cache's tensors are updated in place (the returned cache shares
    them, with ``lengths + 1``): a caller that needs the old cache clones
    it.  MLA attends in the absorbed form against the latent cache.
    """
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    lengths = cache.lengths
    for i, lp, dense in _layers(params, cfg):
        h = rmsnorm(x, lp["ln1"], cfg.rms_eps)
        if cfg.attention == "gqa":
            a = _gqa_block_decode(cfg, lp["attn"], h, cache.k[i], cache.v[i],
                                  lengths)
        else:
            a, _ = mla_attention_decode(lp["attn"], h, cfg,
                                        MLACache(cache.k[i], cache.v[i]),
                                        lengths)
        x = x + a
        h = rmsnorm(x, lp["ln2"], cfg.rms_eps)
        x = x + _ffn(cfg, lp, h, dense)
    return _logits(params, x, cfg), KVCache(cache.k, cache.v, lengths + 1)


def decode_step_quant(params, cache: QuantKVCache, tokens: torch.Tensor,
                      cfg: TransformerConfig
                      ) -> tuple[torch.Tensor, QuantKVCache]:
    """GQA decode against an int8 KV cache: the contract of
    :func:`decode_step`, with a :class:`kv_quant.QuantKVCache` (updated in
    place).  As the reference, it runs ``params["layers"]`` (no prefix
    layers) and refuses MLA, whose latent cache is already compact."""
    if cfg.attention != "gqa":
        raise ValueError("int8 cache: GQA archs (MLA is compact)")
    x = params["embed"][tokens].to(dtype_of(cfg.dtype))
    lengths = cache.lengths
    b = tokens.shape[0]
    hq, dh = cfg.n_heads, cfg.d_head
    n_stack = cache.k_q.shape[0]
    for i in range(n_stack):
        lp = _layer(params["layers"], i)
        h = rmsnorm(x, lp["ln1"], cfg.rms_eps)
        q, k, v = _qkv(cfg, lp["attn"], h, lengths[:, None])
        # quantize the new token's K/V and insert at position ``lengths``
        for payload, scales, new in ((cache.k_q, cache.k_scale, k),
                                     (cache.v_q, cache.v_scale, v)):
            nq, ns = quantize_kv(new[:, 0])        # (B,Hkv,dh), (B,Hkv)
            store_at(payload[i], nq, lengths)
            store_at(scales[i], ns, lengths)
        a = quant_attention_decode(q, cache.k_q[i], cache.k_scale[i],
                                   cache.v_q[i], cache.v_scale[i], lengths + 1)
        x = x + mm(a.reshape(b, 1, hq * dh).to(h.dtype), lp["attn"]["wo"])
        h2 = rmsnorm(x, lp["ln2"], cfg.rms_eps)
        x = x + _ffn(cfg, lp, h2, False)
    return _logits(params, x, cfg), cache._replace(lengths=lengths + 1)


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Sequential-decode prefill (the clarity-first reference)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    logits = None
    for i in range(s):
        logits, cache = decode_step(params, cache, tokens[:, i:i + 1], cfg)
    return logits, cache
