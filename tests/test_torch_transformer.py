"""The port's dense GQA transformer against ``repro.models.transformer``.

Both packages compute on the same weights: the reference's
``init_params(jax.random.key(0), cfg)`` carried over by
``convert.transformer_params_from_numpy``, and the same numpy tokens.  On
the CPU the port's prefill attention is kernel B8's plain version.

Tolerances: float32 rtol = atol = 1e-4.  bfloat16: twice the reference's
own gap between its two attention paths on the same weights and tokens
(``forward_with_cache`` through ``gqa_attention`` against the same with
the Pallas flash kernel in interpret mode), measured in this module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.kernels import ops as jops
from repro.models.transformer import attention as jattn
from repro.models.transformer import config as jconfig
from repro.models.transformer import model as M
from repro.models.transformer import rope as jrope
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import lm_archs as tarchs
from repro_torch.kernels import _build
from repro_torch.models.transformer import attention as tattn
from repro_torch.models.transformer import config as tconfig
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer import rope as trope

F32_TOL = 1e-4
S = 16          # prompt length of the model tests
MAX_LEN = 24


def _tiny(**kw):
    base = dict(
        name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=128, rope_theta=10_000.0, dtype="float32",
        param_dtype="float32", max_seq_len=32, remat=False,
    )
    base.update(kw)
    return base


VARIANTS = {
    "tiny_gqa": {},
    "qkv_bias": dict(qkv_bias=True),
    "tied": dict(tie_embeddings=True),
    "bf16": dict(dtype="bfloat16"),
}


def _configs(name):
    kw = _tiny(**VARIANTS[name])
    return jconfig.TransformerConfig(**kw), tconfig.TransformerConfig(**kw)


def _setup(name, seed=0):
    jc, tc = _configs(name)
    jp = M.init_params(jax.random.key(seed), jc)
    if jc.qkv_bias:  # the reference initialises biases to 0: make them count
        rng = np.random.default_rng(7)
        attn = dict(jp["layers"]["attn"])
        for b in ("bq", "bk", "bv"):
            attn[b] = jnp.asarray(rng.normal(size=attn[b].shape)
                                  .astype(np.float32) * 0.1)
        jp = {**jp, "layers": {**jp["layers"], "attn": attn}}
    tp = convert.transformer_params_from_numpy(jax.tree.map(np.asarray, jp),
                                               tc, device="cpu")
    return jc, tc, jp, tp


def _tokens(n, vocab=128, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (2, n)).astype(np.int32)


def _np(x):
    return np.asarray(x.to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def bf16_gap():
    """The reference's own bf16 gap: its forward_with_cache through
    gqa_attention against the same through the Pallas flash kernel."""
    jc, _, jp, _ = _setup("bf16")
    toks = jnp.asarray(_tokens(S))
    plain, _ = M.forward_with_cache(jp, toks, jc, MAX_LEN)
    orig = M.gqa_attention

    def flash(q, k, v, *, causal=True, chunk=0):
        return jops.flash_attention(q, k, v, causal=causal, interpret=True)

    M.gqa_attention = flash
    try:
        fl, _ = M.forward_with_cache(jp, toks, jc, MAX_LEN)
    finally:
        M.gqa_attention = orig
    gap = float(np.abs(_np(plain) - _np(fl)).max())
    print(f"reference bf16 gqa vs flash, max |dlogit|: {gap}")
    assert 0.0 < gap < 0.1 * float(np.abs(_np(plain)).max())
    return gap


def _tol(name, bf16_gap):
    return (0.0, 2.0 * bf16_gap) if name == "bf16" else (F32_TOL, F32_TOL)


def _close(got, want, name, bf16_gap):
    rtol, atol = _tol(name, bf16_gap)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# rope and attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 40_000, (2, 12)).astype(np.int32)
    x = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16, 500_000.0)
    tc, ts = trope.rope_cos_sin(torch.tensor(pos), 16, 500_000.0)
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=0, atol=1e-5)
    want = jrope.apply_rope(jnp.asarray(x).astype(dtype), jc, js)
    got = trope.apply_rope(torch.tensor(x).to(getattr(torch, dtype)), tc, ts)
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


ATTN_CASES = {
    "dense": dict(s=16, t=16, kw=dict(causal=True)),
    "chunked": dict(s=16, t=16, kw=dict(causal=True, chunk=4)),
    "decode": dict(s=1, t=24, kw=dict(causal=False, kv_len=np.array([5, 17],
                                                                     np.int32))),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_gqa_attention_matches_reference(case, dtype):
    c = ATTN_CASES[case]
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, c["s"], 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, c["t"], 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, c["t"], 2, 8)).astype(np.float32)
    kw = dict(c["kw"])
    jkw = {**kw, **({"kv_len": jnp.asarray(kw["kv_len"])} if "kv_len" in kw else {})}
    tkw = {**kw, **({"kv_len": torch.tensor(kw["kv_len"])} if "kv_len" in kw else {})}
    want = jattn.gqa_attention(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)),
                               **jkw)
    got = tattn.gqa_attention(*(torch.tensor(x).to(getattr(torch, dtype))
                                for x in (q, k, v)), **tkw)
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    tol = F32_TOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_matches_reference(name, bf16_gap):
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(S)
    want, _ = M.forward(jp, jnp.asarray(toks), jc)
    got, aux = TM.forward(tp, torch.tensor(toks), tc)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, name, bf16_gap)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_with_cache_matches_reference(name, bf16_gap):
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(S)
    want, wc = M.forward_with_cache(jp, jnp.asarray(toks), jc, MAX_LEN)
    got, gc = TM.forward_with_cache(tp, torch.tensor(toks), tc, MAX_LEN)
    _close(got, want, name, bf16_gap)
    assert gc.k.shape == wc.k.shape and gc.k.dtype == TM.dtype_of(tc.dtype)
    _close(gc.k, wc.k, name, bf16_gap)
    _close(gc.v, wc.v, name, bf16_gap)
    assert (gc.k[:, :, S:] == 0).all() and (gc.v[:, :, S:] == 0).all()
    np.testing.assert_array_equal(gc.lengths.numpy(), np.asarray(wc.lengths))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_decode_steps_match_reference(name, bf16_gap):
    """A prefill of S tokens, then 4 decode steps, in both packages."""
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(S + 4)
    _, jcache = M.forward_with_cache(jp, jnp.asarray(toks[:, :S]), jc, MAX_LEN)
    _, tcache = TM.forward_with_cache(tp, torch.tensor(toks[:, :S]), tc, MAX_LEN)
    step = jax.jit(lambda p, c, t: M.decode_step(p, c, t, jc))
    for i in range(S, S + 4):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        got, tcache = TM.decode_step(tp, tcache, torch.tensor(toks[:, i:i + 1]), tc)
        assert got.shape == want.shape
        _close(got, want, name, bf16_gap)
    _close(tcache.k, jcache.k, name, bf16_gap)
    _close(tcache.v, jcache.v, name, bf16_gap)
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prefill_matches_reference(name, bf16_gap):
    jc, tc, jp, tp = _setup(name)
    toks = _tokens(8)
    want, wc = jax.jit(M.prefill, static_argnums=(2, 3))(jp, jnp.asarray(toks),
                                                        jc, 12)
    got, gc = TM.prefill(tp, torch.tensor(toks), tc, 12)
    _close(got, want, name, bf16_gap)
    _close(gc.k, wc.k, name, bf16_gap)
    _close(gc.v, wc.v, name, bf16_gap)


def _plain_attention(cfg):
    """The reference's route: the prefill's attention through the plain
    gqa_attention (and attn_chunk), to stand in for TM.flash_attention."""
    def attend(q, k, v, *, causal=True):
        return tattn.gqa_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return attend


@pytest.mark.parametrize("name", ["tiny_gqa", "bf16"])
def test_plain_attention_route_matches_reference(name, bf16_gap, monkeypatch):
    """With the plain gqa_attention in B8's place the model is the
    reference's own route (and attn_chunk)."""
    jc, tc, jp, tp = _setup(name)
    jc = dataclasses.replace(jc, attn_chunk=4)
    tc = dataclasses.replace(tc, attn_chunk=4)
    toks = _tokens(S)
    want, _ = M.forward(jp, jnp.asarray(toks), jc)
    monkeypatch.setattr(TM, "flash_attention", _plain_attention(tc))
    got, _ = TM.forward(tp, torch.tensor(toks), tc)
    _close(got, want, name, bf16_gap)


def test_prefill_routes_attention_through_the_flash_wrapper(monkeypatch):
    calls = []
    orig = TM.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append((tuple(q.shape), causal))
        return orig(q, k, v, causal=causal)

    monkeypatch.setattr(TM, "flash_attention", spy)
    _, tc, _, tp = _setup("tiny_gqa")
    _build.reset_launches()
    TM.forward_with_cache(tp, torch.tensor(_tokens(S)), tc, MAX_LEN)
    assert calls == [((2, S, 4, 8), True)] * tc.n_layers
    assert sum(_build.LAUNCHES.values()) == 0   # CPU tensors: plain version
    calls.clear()
    TM.forward(tp, torch.tensor(_tokens(S)), tc)
    assert calls == [((2, S, 4, 8), True)] * tc.n_layers


# ---------------------------------------------------------------------------
# the reference's consistency tests, on the port alone
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tiny_gqa", "qkv_bias", "tied"])
def test_decode_matches_forward(name):
    """Step-by-step decode must reproduce the causal forward logits."""
    _, tc, _, tp = _setup(name)
    tokens = torch.tensor(_tokens(10))
    full, _ = TM.forward(tp, tokens, tc)
    cache = TM.init_cache(tc, 2, 16, device="cpu")
    outs = []
    for i in range(10):
        lg, cache = TM.decode_step(tp, cache, tokens[:, i:i + 1], tc)
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)


def test_prefill_cache_matches_decode():
    """forward_with_cache + decode continuation == all-decode path."""
    _, tc, _, tp = _setup("tiny_gqa")
    tokens = torch.tensor(_tokens(8))
    nxt = torch.tensor(_tokens(1, seed=2))
    logits_pf, cache_pf = TM.forward_with_cache(tp, tokens, tc, max_len=16)
    lg_a, _ = TM.decode_step(tp, cache_pf, nxt, tc)
    cache = TM.init_cache(tc, 2, 16, device="cpu")
    for i in range(8):
        lg, cache = TM.decode_step(tp, cache, tokens[:, i:i + 1], tc)
    np.testing.assert_allclose(logits_pf[:, -1].numpy(), lg[:, 0].numpy(),
                               rtol=2e-3, atol=2e-3)
    lg_b, _ = TM.decode_step(tp, cache, nxt, tc)
    np.testing.assert_allclose(lg_a.numpy(), lg_b.numpy(), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# parameters and configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_init_params_has_the_reference_layout(name):
    jc, tc, jp, _ = _setup(name)
    tp = TM.init_params(tc, seed=3, device="cpu")
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(jp)}

    def flat(node, prefix=""):
        out = {}
        for k, v in node.items():
            key = f"{prefix}['{k}']"
            out.update(flat(v, key) if isinstance(v, dict) else {key: v})
        return out

    tflat = flat(tp)
    assert sorted(tflat) == sorted(jflat)
    for key, v in tflat.items():
        assert tuple(v.shape) == jflat[key].shape, key
        assert str(v.dtype).split(".")[-1] == str(jflat[key].dtype), key
    # the same scales: w ~ N(0, d^-1), so mean square d^-1 within 10%
    ms = float((tp["layers"]["attn"]["wq"].float() ** 2).mean())
    assert abs(ms * tc.d_model - 1.0) < 0.1


def test_transformer_params_keep_bf16_leaves_and_check_depth():
    jc, tc = _configs("tiny_gqa")
    jc16 = dataclasses.replace(jc, param_dtype="bfloat16")
    jp = M.init_params(jax.random.key(0), jc16)
    tp = convert.transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                               device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tp["embed"]), _np(jp["embed"]))
    with pytest.raises(ValueError, match="stacked layers"):
        convert.transformer_params_from_numpy(
            jax.tree.map(np.asarray, jp), dataclasses.replace(tc, n_layers=3),
            device="cpu")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("fn", ["qwen2_5_14b", "llama3_405b", "llama3_2_1b",
                                "deepseek_v2_236b", "grok_1_314b"])
def test_lm_configs_are_the_references(fn):
    want = getattr(jarchs, fn)()
    got = getattr(tarchs, fn)()
    assert got.arch_id == want.arch_id and got.family == want.family
    for g, w in ((got.model_cfg, want.model_cfg), (got.smoke_cfg, want.smoke_cfg)):
        gf, wf = _fields(g), _fields(w)
        for key, value in gf.items():
            if key in ("mla", "moe"):
                assert (value is None) == (wf[key] is None)
                if value is not None:
                    assert dataclasses.asdict(value) == dataclasses.asdict(wf[key])
            else:
                assert value == wf[key], key
        assert g.n_params == w.n_params
    assert sorted(got.shapes) == sorted(want.shapes)
    for key, cell in got.shapes.items():
        ref = want.shapes[key]
        assert (cell.name, cell.kind, cell.params, cell.exec_overrides,
                cell.skip_reason) == (ref.name, ref.kind, ref.params,
                                      ref.exec_overrides, ref.skip_reason)
    assert tbase.get_spec(want.arch_id).arch_id == want.arch_id


def test_chip_bar_covers_the_references_gap():
    """chip_smoke.py holds the llama3.2-1b prefill through B8 against the
    plain attention (and decode against the prefill) to a relative RMS gap
    of LM_REL_RMS_BAR: 3x the reference's own gap between its gqa_attention
    and its Pallas flash kernel at bf16, on the llama3.2-1b smoke config at
    the full model's depth of 16 layers."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    jc = dataclasses.replace(jarchs.llama3_2_1b().smoke_cfg, dtype="bfloat16",
                             n_layers=16)
    jp = M.init_params(jax.random.key(0), jc)
    toks = jnp.asarray(_tokens(64, vocab=jc.vocab_size))
    plain, _ = M.forward_with_cache(jp, toks, jc, 64)
    orig = M.gqa_attention

    def flash(q, k, v, *, causal=True, chunk=0):
        return jops.flash_attention(q, k, v, causal=causal, interpret=True)

    M.gqa_attention = flash
    try:
        fl, _ = M.forward_with_cache(jp, toks, jc, 64)
    finally:
        M.gqa_attention = orig
    d = _np(plain) - _np(fl)
    rel = float(np.sqrt((d * d).mean() / (_np(plain) ** 2).mean()))
    print(f"reference bf16 gqa vs flash, relative RMS: {rel:.5f}")
    assert 2.5 * rel <= chip.LM_REL_RMS_BAR <= 3.5 * rel


def test_entry_points_default_to_the_card():
    """device=None means CUDA: without a card the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    jc, tc = _configs("tiny_gqa")
    tree = jax.tree.map(np.asarray, M.init_params(jax.random.key(0), jc))
    for build in (lambda: TM.init_params(tc),
                  lambda: TM.init_cache(tc, 1, 8),
                  lambda: convert.transformer_params_from_numpy(tree, tc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
