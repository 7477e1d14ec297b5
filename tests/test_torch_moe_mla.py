"""The port's MoE and MLA transformers and int8 KV cache against the
reference's ``repro.models.transformer``.

Both packages compute on the same weights: the reference's
``init_params(jax.random.key(0), cfg)`` carried over by
``convert.transformer_params_from_numpy``, and the same numpy tokens, on
the smoke configurations of both registries (``dsv2``: MLA, one leading
dense layer, MoE with a shared expert; ``grok``: GQA, every layer MoE).
On the CPU a GQA prefill's attention is kernel B8's plain version.

Tolerances: float32 rtol = atol = 1e-4.  bfloat16 (``grok_bf16``): twice
the reference's own gap between its two attention paths on the same
weights and tokens (``forward_with_cache`` through ``gqa_attention``
against the same with the Pallas flash kernel in interpret mode),
measured in this module.  The int8 caches: their payloads within one
step of the integer grid (a quotient on a rounding boundary may round
either way after float32 products of another order), their scales and
outputs at the float32 tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.kernels import ops as jops
from repro.models.transformer import kv_quant as jkv
from repro.models.transformer import mla as jmla
from repro.models.transformer import model as M
from repro.models.transformer import moe as jmoe
from repro_torch import convert
from repro_torch.configs import lm_archs as tarchs
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.transformer import kv_quant as tkv
from repro_torch.models.transformer import mla as tmla
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer import moe as tmoe
from repro_torch.models.transformer.config import MoEConfig

F32_TOL = 1e-4
S = 16
MAX_LEN = 24

ARCHS = {"dsv2": "deepseek_v2_236b", "grok": "grok_1_314b"}
VARIANTS = {"dsv2": ("dsv2", {}), "grok": ("grok", {}),
            "grok_bf16": ("grok", dict(dtype="bfloat16"))}


def _configs(name):
    arch, kw = VARIANTS[name]
    fn = ARCHS[arch]
    jc = dataclasses.replace(getattr(jarchs, fn)().smoke_cfg, **kw)
    tc = dataclasses.replace(getattr(tarchs, fn)().smoke_cfg, **kw)
    return jc, tc


_PARAMS = {}
_jinit = jax.jit(M.init_params, static_argnums=1)


def _setup(name):
    if name not in _PARAMS:
        jc, tc = _configs(name)
        jp = _jinit(jax.random.key(0), jc)
        tp = convert.transformer_params_from_numpy(
            jax.tree.map(np.asarray, jp), tc, device="cpu")
        _PARAMS[name] = (jc, tc, jp, tp)
    return _PARAMS[name]


_jfwc = jax.jit(M.forward_with_cache, static_argnums=(2, 3))


def _tokens(n, vocab=256, seed=1, b=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def bf16_gap():
    """The reference's own bf16 gap on grok's smoke config: its
    forward_with_cache through gqa_attention against the same through the
    Pallas flash kernel, max |dlogit|, the median over three token draws.
    A bf16 difference in attention can flip a token's expert choice
    (routing is a step function of the router's input): on one draw of
    the three the reference's own paths route a token apart (gap 1.32,
    against 0.035 and 0.055 on the others), so the median is the gap of
    attention's roundings alone."""
    jc, _, jp, _ = _setup("grok_bf16")
    orig = M.gqa_attention

    def flash(q, k, v, *, causal=True, chunk=0):
        return jops.flash_attention(q, k, v, causal=causal, interpret=True)

    gaps = []
    run_plain = jax.jit(lambda p, t: M.forward_with_cache(p, t, jc, MAX_LEN))
    run_flash = jax.jit(lambda p, t: M.forward_with_cache(p, t, jc, MAX_LEN))
    for seed in (1, 2, 3):
        toks = jnp.asarray(_tokens(S, seed=seed))
        plain, _ = run_plain(jp, toks)
        M.gqa_attention = flash      # read when run_flash traces
        try:
            fl, _ = run_flash(jp, toks)
        finally:
            M.gqa_attention = orig
        gaps.append(float(np.abs(_np(plain) - _np(fl)).max()))
    gap = float(np.median(gaps))
    print(f"reference bf16 gqa vs flash on grok-smoke, max |dlogit|: {gaps}")
    assert 0.0 < gap < 0.1 * float(np.abs(_np(plain)).max())
    return gap


def _close(got, want, name, bf16_gap=None):
    if name == "grok_bf16":
        rtol, atol = 0.0, 2.0 * bf16_gap
    else:
        rtol, atol = F32_TOL, F32_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


@pytest.fixture
def gap(request):
    """bf16_gap only for the bf16 variant (the others need no reference
    run of the flash kernel)."""
    name = request.node.callspec.params["name"]
    return request.getfixturevalue("bf16_gap") if name == "grok_bf16" else None


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_reference(name, gap):
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(S)
    want, waux = jax.jit(M.forward, static_argnums=2)(jp, jnp.asarray(toks), jc)
    got, aux = TM.forward(tp, torch.tensor(toks), tc)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, want, name, gap)
    np.testing.assert_allclose(float(aux), float(waux), rtol=F32_TOL, atol=1e-6)
    assert float(aux) > 0.0


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_with_cache_matches_reference(name, gap):
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(S)
    want, wc = _jfwc(jp, jnp.asarray(toks), jc, MAX_LEN)
    got, gc = TM.forward_with_cache(tp, torch.tensor(toks), tc, MAX_LEN)
    _close(got, want, name, gap)
    assert gc.k.shape == wc.k.shape and gc.v.shape == wc.v.shape
    _close(gc.k, wc.k, name, gap)      # MLA: the latent c_kv
    _close(gc.v, wc.v, name, gap)      # MLA: the roped k_rope
    assert (gc.k[:, :, S:] == 0).all() and (gc.v[:, :, S:] == 0).all()
    np.testing.assert_array_equal(gc.lengths.numpy(), np.asarray(wc.lengths))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_decode_steps_match_reference(name, gap):
    """A prefill of S tokens, then 4 decode steps, in both packages."""
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(S + 4)
    _, jcache = _jfwc(jp, jnp.asarray(toks[:, :S]), jc, MAX_LEN)
    _, tcache = TM.forward_with_cache(tp, torch.tensor(toks[:, :S]), tc, MAX_LEN)
    step = jax.jit(lambda p, c, t: M.decode_step(p, c, t, jc))
    for i in range(S, S + 4):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, tcache = TM.decode_step(tp, tcache, torch.tensor(toks[:, i:i + 1]),
                                     tc)
        assert got.shape == want.shape
        _close(got, want, name, gap)
    _close(tcache.k, jcache.k, name, gap)
    _close(tcache.v, jcache.v, name, gap)
    np.testing.assert_array_equal(tcache.lengths.numpy(),
                                  np.asarray(jcache.lengths))


@pytest.mark.parametrize("name", ["dsv2", "grok"])
def test_prefill_matches_reference(name):
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(6)
    want, wc = jax.jit(M.prefill, static_argnums=(2, 3))(
        jp, jnp.asarray(toks), jc, 8)
    got, gc = TM.prefill(tp, torch.tensor(toks), tc, 8)
    _close(got, want, name)
    _close(gc.k, wc.k, name)
    _close(gc.v, wc.v, name)


@pytest.mark.parametrize("name", ["dsv2", "grok"])
def test_decode_matches_forward(name):
    """Step-by-step decode reproduces the causal forward's logits (the
    reference's own consistency check, on the port alone).  A group's
    capacity drops depend on the group's other tokens, so the capacity is
    lifted to the whole group (no pair dropped in either path: a decode
    step is a group of one token per row)."""
    _, tc, _, tp = _setup(name)
    tc = dataclasses.replace(tc, moe=dataclasses.replace(
        tc.moe, capacity_factor=tc.moe.n_experts / tc.moe.top_k))
    tokens = torch.tensor(_tokens(8))
    full, _ = TM.forward(tp, tokens, tc)
    cache = TM.init_cache(tc, 2, 12, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = TM.decode_step(tp, cache, tokens[:, i:i + 1], tc)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_grok_prefill_routes_attention_through_b8_and_dsv2_does_not(monkeypatch):
    calls = []
    orig = TM.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(tuple(q.shape))
        return orig(q, k, v, causal=causal)

    monkeypatch.setattr(TM, "flash_attention", spy)
    _build.reset_launches()
    for name, want in (("grok", 2), ("dsv2", 0)):
        calls.clear()
        _, tc, _, tp = _setup(name)
        TM.forward_with_cache(tp, torch.tensor(_tokens(S)), tc, MAX_LEN)
        assert len(calls) == want
    assert sum(_build.LAUNCHES.values()) == 0   # CPU tensors: plain version


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------
def _moe_case(capacity_factor, n_shared=0):
    moe = MoEConfig(n_experts=4, top_k=2, n_shared=n_shared, d_expert_ff=32,
                    capacity_factor=capacity_factor)
    jp = jmoe.moe_init(jax.random.key(3), 32, moe, jnp.float32)
    return moe, jp, {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("tokens", [(2, 8), (2, 1024)])
def test_moe_ffn_drops_the_same_pairs(tokens):
    """At capacity factor 0.5 pairs are dropped (and at 1,024 tokens a
    row, two groups of 1,024): the outputs agree, and a token whose every
    pair the port drops has a routed output of exactly 0 in both."""
    moe, jp, tp = _moe_case(0.5)
    x = np.random.default_rng(5).normal(size=tokens + (32,)).astype(np.float32)
    want, waux = jax.jit(jmoe.moe_ffn, static_argnames=("moe", "dtype"))(
        jp, jnp.asarray(x), moe=moe, dtype=jnp.float32)
    got, aux = tmoe.moe_ffn(tp, torch.tensor(x), moe, dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=F32_TOL)
    n = tokens[0] * tokens[1]
    gsz = min(1024, n)
    xt = torch.tensor(x).reshape(n // gsz, gsz, 32)
    _, _, top_i = tmoe.route(xt, tp["router"], moe)
    keep = tmoe.slots(top_i, moe.n_experts) < tmoe.capacity(moe, gsz)
    gone = ~keep.any(dim=-1).reshape(-1)
    assert int((~keep).sum()) > 0
    assert bool(gone.any())
    assert (_np(want).reshape(n, 32)[gone.numpy()] == 0).all()
    assert (got.reshape(n, 32)[gone] == 0).all()


def test_moe_ffn_shared_experts_bf16_and_ties():
    """Shared experts after the combine, bf16 activations; equal router
    probabilities go to the lower expert index, as jax.lax.top_k."""
    moe, jp, tp = _moe_case(1.25, n_shared=1)
    x = np.random.default_rng(6).normal(size=(2, 8, 32)).astype(np.float32)
    want, _ = jax.jit(jmoe.moe_ffn, static_argnames="moe")(
        jp, jnp.asarray(x).astype(jnp.bfloat16), moe=moe)
    got, _ = tmoe.moe_ffn(tp, torch.tensor(x).to(torch.bfloat16), moe)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -6, atol=2 ** -6)
    tie = torch.tensor([[[0.3, 0.2, 0.3, 0.2]]]).log()
    _, _, top_i = tmoe.route(tie, torch.eye(4), moe)
    _, want_i = jax.lax.top_k(jax.nn.softmax(jnp.asarray(tie.numpy())), 2)
    assert top_i.tolist() == np.asarray(want_i).tolist() == [[[0, 2]]]


def test_moe_ffn_refuses_a_ragged_group():
    moe, _, tp = _moe_case(1.25)
    with pytest.raises(ValueError, match="whole groups"):
        tmoe.moe_ffn(tp, torch.zeros((1, 1536, 32)), moe)


# ---------------------------------------------------------------------------
# MLA decode and the int8 caches
# ---------------------------------------------------------------------------
def _latent_case(seed=7):
    jc, tc, jp, tp = _setup("dsv2")
    m = tc.mla
    rng = np.random.default_rng(seed)
    b, t = 2, 12
    lengths = np.array([5, 9], np.int32)
    c_kv = rng.normal(size=(b, t, m.kv_lora_rank)).astype(np.float32)
    k_rope = rng.normal(size=(b, t, m.qk_rope_head_dim)).astype(np.float32)
    for i, n in enumerate(lengths):      # the slots past the fill are 0
        c_kv[i, n:] = 0.0
        k_rope[i, n:] = 0.0
    x = rng.normal(size=(b, 1, tc.d_model)).astype(np.float32)
    return (jc, tc, jp["layers"]["attn"], tp["layers"]["attn"], lengths,
            c_kv, k_rope, x)


def _first(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_mla_attention_decode_matches_reference():
    jc, tc, jattn, tattn, lengths, c_kv, k_rope, x = _latent_case()
    want, wcache = jax.jit(jmla.mla_attention_decode, static_argnums=2)(
        _first(jattn), jnp.asarray(x), jc,
        jmla.MLACache(jnp.asarray(c_kv), jnp.asarray(k_rope)),
        jnp.asarray(lengths))
    cache = tmla.MLACache(torch.tensor(c_kv), torch.tensor(k_rope))
    got, gcache = tmla.mla_attention_decode(
        TM._layer(tattn, 0), torch.tensor(x), tc, cache, torch.tensor(lengths))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)
    for g, w in zip(gcache, wcache):
        np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL, atol=F32_TOL)


def test_mla_attention_decode_quant_matches_reference():
    jc, tc, jattn, tattn, lengths, c_kv, k_rope, x = _latent_case(8)
    cq, cs = jkv.quantize_kv(jnp.asarray(c_kv))
    cs = jnp.where(jnp.asarray(c_kv).any(-1), cs, 0.0)   # empty slots: 0
    want, (wq, ws, wr) = jax.jit(jmla.mla_attention_decode_quant,
                                 static_argnums=2)(
        _first(jattn), jnp.asarray(x), jc, cq, cs, jnp.asarray(k_rope),
        jnp.asarray(lengths))
    tq, ts, tr = (torch.tensor(np.asarray(a)) for a in (cq, cs, k_rope))
    got, (gq, gs, gr) = tmla.mla_attention_decode_quant(
        TM._layer(tattn, 0), torch.tensor(x), tc, tq, ts, tr,
        torch.tensor(lengths))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL, atol=F32_TOL)
    assert gq.dtype == torch.int8
    assert np.abs(gq.numpy().astype(int) - np.asarray(wq).astype(int)).max() <= 1
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=F32_TOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=F32_TOL,
                               atol=F32_TOL)


def test_quantize_kv_rounds_half_to_even():
    """Quotients on .5 exactly (scale 1 from an amax of 127) round to even,
    as jnp.round; and random rows as the reference's."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                   np.float32)
    x = np.stack([row, np.random.default_rng(9).normal(size=8)
                  .astype(np.float32)])
    wq, ws = jkv.quantize_kv(jnp.asarray(x))
    gq, gs = tkv.quantize_kv(torch.tensor(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert gq[0].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        tkv.dequantize_kv(gq, gs, torch.float32).numpy(),
        np.asarray(jkv.dequantize_kv(wq, ws, jnp.float32)))


def _tiny_gqa():
    from repro.models.transformer import config as jconfig
    from repro_torch.models.transformer import config as tconfig
    kw = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
              d_ff=64, vocab_size=128, rope_theta=10_000.0, dtype="float32",
              param_dtype="float32", max_seq_len=32, remat=False)
    jc, tc = jconfig.TransformerConfig(**kw), tconfig.TransformerConfig(**kw)
    jp = _jinit(jax.random.key(0), jc)
    tp = convert.transformer_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               tc, device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("name", ["tiny_gqa", "grok"])
def test_decode_step_quant_matches_reference(name):
    """Six int8-cache decode steps from an empty cache, in both packages."""
    jc, tc, jp, tp = _tiny_gqa() if name == "tiny_gqa" else _setup(name)
    toks = _tokens(6, vocab=tc.vocab_size)
    jcache = jkv.init_quant_cache(jc, 2, 8)
    tcache = tkv.init_quant_cache(tc, 2, 8, device="cpu")
    step = jax.jit(lambda p, c, t: M.decode_step_quant(p, c, t, jc))
    for i in range(6):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, tcache = TM.decode_step_quant(tp, tcache,
                                           torch.tensor(toks[:, i:i + 1]), tc)
        np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                                   atol=F32_TOL)
    for g, w in ((tcache.k_q, jcache.k_q), (tcache.v_q, jcache.v_q)):
        assert g.dtype == torch.int8
        assert np.abs(g.numpy().astype(int) - np.asarray(w).astype(int)).max() <= 1
    for g, w in ((tcache.k_scale, jcache.k_scale), (tcache.v_scale, jcache.v_scale)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL)
    assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist() == [6, 6]


def test_decode_step_quant_refuses_mla():
    _, tc, _, tp = _setup("dsv2")
    with pytest.raises(ValueError, match="GQA"):
        TM.decode_step_quant(tp, None, torch.zeros((1, 1), dtype=torch.long), tc)


# ---------------------------------------------------------------------------
# parameters and configurations
# ---------------------------------------------------------------------------
def _flat(node, prefix=""):
    items = (node.items() if isinstance(node, dict) else enumerate(node))
    out = {}
    for k, v in items:
        key = f"{prefix}[{k!r}]" if isinstance(k, str) else f"{prefix}[{k}]"
        out.update(_flat(v, key) if isinstance(v, (dict, list)) else {key: v})
    return out


@pytest.mark.parametrize("name", ["dsv2", "grok"])
def test_init_params_has_the_reference_layout(name):
    jc, tc, jp, _ = _setup(name)
    tp = TM.init_params(tc, seed=3, device="cpu")
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    tflat = _flat(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, v in tflat.items():
        assert tuple(v.shape) == jflat[key].shape, key
        assert str(v.dtype).split(".")[-1] == str(jflat[key].dtype), key
    # the same scales: experts ~ N(0, d^-1), so mean square d^-1 within 10%
    ms = float((tp["layers"]["ffn"]["w_experts_gate"].float() ** 2).mean())
    assert abs(ms * tc.d_model - 1.0) < 0.1


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_full_configs_build_on_the_meta_device(arch, monkeypatch):
    """init_params, init_cache, forward and decode_step build the full
    configurations (shapes only, on the meta device; the prefill's
    attention through B8's plain version)."""
    from repro_torch.configs import base as tbase
    cfg = tbase.get_spec(arch).model_cfg
    monkeypatch.setattr(TM, "flash_attention", fa.flash_attention_plain)
    p = TM.init_params(cfg, device="meta")
    assert len(p.get("prefix_layers", [])) == (1 if arch.startswith("deep") else 0)
    n = sum(x.numel() for x in _flat(p).values())
    assert abs(n - cfg.n_params) < 1e-3 * cfg.n_params
    tok = torch.zeros((1, 1024), dtype=torch.long, device="meta")
    logits, aux = TM.forward(p, tok, cfg)
    assert logits.shape == (1, 1024, cfg.vocab_size) and aux.shape == ()
    cache = TM.init_cache(cfg, 1, 1025, device="meta")
    lg, cache = TM.decode_step(p, cache, tok[:, :1], cfg)
    assert lg.shape == (1, 1, cfg.vocab_size)
    assert cache.k.shape[:3] == (cfg.n_layers, 1, 1025)


@pytest.mark.parametrize("fn", ["qwen2_5_14b", "llama3_405b", "llama3_2_1b",
                                "deepseek_v2_236b", "grok_1_314b"])
def test_n_active_params_matches_reference(fn):
    want, got = getattr(jarchs, fn)(), getattr(tarchs, fn)()
    for w, g in ((want.model_cfg, got.model_cfg), (want.smoke_cfg, got.smoke_cfg)):
        assert g.n_active_params == w.n_active_params
        assert g.n_active_params <= g.n_params


def test_convert_carries_prefix_layers_and_checks_depth():
    jc, tc, jp, tp = _setup("dsv2")
    assert isinstance(tp["prefix_layers"], list) and len(tp["prefix_layers"]) == 1
    np.testing.assert_array_equal(
        tp["prefix_layers"][0]["ffn"]["w_gate"].numpy(),
        np.asarray(jp["prefix_layers"][0]["ffn"]["w_gate"]))
    with pytest.raises(ValueError, match="1 prefix and 2 stacked layers"):
        convert.transformer_params_from_numpy(
            jax.tree.map(np.asarray, jp), dataclasses.replace(tc, n_layers=4),
            device="cpu")
