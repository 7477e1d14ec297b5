"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a) and ``nvcc``, is marked
``cuda`` and skips without a card.  The file imports no JAX, so it also
runs on a machine without it; the repository's ``conftest.py`` imports the
JAX package, so there run it with::

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import lc_rwmd as tlc
from repro_torch.core import pipeline as tpipe
from repro_torch.data.synth import CorpusSpec, make_corpus
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_stream as tfs
from repro_torch.kernels import lc_rwmd_phase1 as tp1
from repro_torch.kernels import sinkhorn_wmd as tsk
from repro_torch.kernels import segment_spmm as tseg
from repro_torch.kernels import spmm_ell as tsp
from repro_torch.models.transformer import config as tconfig
from repro_torch.models.transformer import model as TM
from repro_torch.models.transformer.attention import gqa_attention

pytestmark = pytest.mark.cuda

CONFIGS = [
    dict(eps=0.01, eps_scaling=4, max_iters=500, tol=1e-5),
    dict(eps=0.02, eps_scaling=3, max_iters=200),
    dict(eps=0.05, eps_scaling=2, max_iters=60),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _ell(rng, n, h, v, pad=0.3):
    ids = rng.integers(0, v, size=(n, h)).astype(np.int32)
    w = rng.uniform(0, 1, size=(n, h)).astype(np.float32)
    w[rng.random(size=w.shape) < pad] = 0.0
    return torch.tensor(ids), torch.tensor(w)


# (v, m, B, h, share of invalid words, a query with no valid word)
PHASE1_CASES = {
    "small": (700, 300, 5, 37, 0.3, False),
    # the main path's batch (B 64, h 48) at ~40% invalid words, on a
    # vocabulary as ragged as the slice's v_e = 73,123 (not a tile multiple)
    "batch64": (73123, 300, 64, 48, 0.4, True),
    "b1": (1000, 300, 1, 48, 0.4, False),
    "m64": (3001, 64, 9, 21, 0.4, True),
    "m70": (1000, 70, 7, 20, 0.3, False),  # rows copied as 4-byte words
}


@pytest.mark.parametrize("case", list(PHASE1_CASES))
def test_phase1_kernel_matches_plain(cuda, case):
    v, m, b, h, p_invalid, empty_query = PHASE1_CASES[case]
    g = torch.Generator().manual_seed(v + b)
    emb = torch.randn(v, m, generator=g).to(cuda)
    t = torch.randn(b, h, m, generator=g).to(cuda)
    valid = (torch.rand(b, h, generator=g) > p_invalid).float()
    valid[:, 0] = 1.0
    if empty_query:
        valid[b // 2] = 0.0
    valid = valid.to(cuda)
    for bf16 in (False, True):
        got = tp1.phase1_sq_cuda(emb, t, valid, bf16_matmul=bf16)
        want = tp1.phase1_sq_plain(emb, t, valid, bf16_matmul=bf16)
        # squared space: the gram form's error scales with the norms
        scale = (emb * emb).sum(1)[:, None] + (t * t).sum(2).amax(1)[None, :]
        assert bool(((got - want).abs() <= 1e-5 * scale).all())
        if empty_query:  # no valid word: 3.4e38 in every row, as on the TPU
            assert bool((got[:, b // 2] == np.float32(tp1.BIG)).all())


def test_spmm_and_fused_topk_kernels_match_plain(cuda):
    rng = np.random.default_rng(1)
    ids, w = (x.to(cuda) for x in _ell(rng, 5000, 48, 900))
    z = torch.tensor(np.abs(rng.normal(size=(900, 70))).astype(np.float32)).to(cuda)
    d = tsp.spmm_ell_cuda(ids, w, z)
    torch.testing.assert_close(d, tsp.spmm_ell_plain(ids, w, z), rtol=1e-5,
                               atol=1e-5)
    for k in (1, 32, 128):
        v, i = tfs.phase2_topk_cuda(ids, w, z, k)
        pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=1024)
        torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
        assert torch.equal(i, pi)
        # the same row sums as the SpMM: bit-equal at the returned ids
        assert torch.equal(v, d.T.gather(1, i.long()))
    v, i = tfs.phase2_topk_cuda(ids, w, z, 16, n_real=777)
    pv, pi = tfs.phase2_topk_plain(ids, w, z, 16, n_real=777)
    assert torch.equal(i, pi) and int(i.max()) < 777
    with pytest.raises(ValueError, match="maximum"):
        tfs.phase2_topk_cuda(ids, w, z, 129)
    # 200,000 rows: every CTA's range spans many steps and several flushes;
    # B = 70 is two query chunks of the kernel.
    ids, w = (x.to(cuda) for x in _ell(rng, 200_000, 48, 900))
    d = tsp.spmm_ell_cuda(ids, w, z)
    for k in (1, 32, 128):
        v, i = tfs.phase2_topk_cuda(ids, w, z, k)
        pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=65536)
        torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
        assert torch.equal(v, d.T.gather(1, i.long()))
        # ids equal wherever the value gaps exceed the sums' rounding
        gap = torch.ones_like(pv, dtype=torch.bool)
        step = pv[:, 1:] - pv[:, :-1] > 1e-4
        gap[:, 1:] &= step
        gap[:, :-1] &= step
        assert torch.equal(i[gap], pi[gap])


def test_fused_topk_kernel_writes_only_its_partials(cuda):
    """With n_real < n the kernel runs one CTA per range of the first
    n_real rows, the partials the wrapper allocates, and writes nothing
    past them."""
    rng = np.random.default_rng(4)
    ids, w = (x.to(cuda) for x in _ell(rng, 5000, 48, 900))
    z = torch.tensor(np.abs(rng.normal(size=(900, 8))).astype(np.float32)).to(cuda)
    n, h = ids.shape
    b, k, n_real = z.shape[1], 16, 777
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, n_ctas = tfs.cta_rows(n_real, n_sm)
    vals = torch.full((n_ctas + 64, b, k), 7.0, device=cuda)
    idx = torch.full((n_ctas + 64, b, k), 7, dtype=torch.int32, device=cuda)
    lib = _build.lib(tfs.NAME)
    code = lib.launch_fused_topk_partial(
        ids.data_ptr(), w.data_ptr(), z.data_ptr(), vals.data_ptr(),
        idx.data_ptr(), n, n_real, h, b, k, rows,
        torch.cuda.current_stream().cuda_stream)
    _build.check(code, tfs.NAME)
    torch.cuda.synchronize()
    assert bool((vals[n_ctas:] == 7.0).all()) and bool((idx[n_ctas:] == 7).all())
    assert int(idx[:n_ctas].max()) < n_real


def test_fused_topk_kernel_tie_order(cuda):
    """Duplicated resident rows tie exactly: (value, doc id) order."""
    rng = np.random.default_rng(2)
    ids, w = _ell(rng, 50, 12, 300)
    ids, w = ids.repeat(40, 1).to(cuda), w.repeat(40, 1).to(cuda)
    z = torch.tensor(np.abs(rng.normal(size=(300, 9))).astype(np.float32)).to(cuda)
    v, i = tfs.phase2_topk_cuda(ids, w, z, 100)
    # one slab, so every duplicate goes through the same GEMM call and ties
    pv, pi = tfs.phase2_topk_plain(ids, w, z, 100, row_block=2000)
    # the two sum the slots in another order: values agree to rounding
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
    assert torch.equal(i, pi)
    tied = v[:, 1:] == v[:, :-1]
    assert bool(tied.any()) and bool((i[:, 1:][tied] > i[:, :-1][tied]).all())


def test_sinkhorn_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(3)
    p, h1, h2, m = 64, 12, 10, 300
    w1 = torch.rand(p, h1, generator=g) * (torch.rand(p, h1, generator=g) > 0.3)
    w2 = torch.rand(p, h2, generator=g) * (torch.rand(p, h2, generator=g) > 0.3)
    w1[:, 0] += 0.1
    w2[:, 0] += 0.1
    w1, w2 = w1 / w1.sum(1, keepdim=True), w2 / w2.sum(1, keepdim=True)
    t1 = torch.randn(p, h1, m, generator=g)
    t2 = torch.randn(p, h2, m, generator=g)
    t1, w1, t2, w2 = (x.to(cuda) for x in (t1, w1, t2, w2))
    for kw in CONFIGS:
        got, _ = tsk.sinkhorn_cuda(t1, w1, t2, w2, **kw)
        want, _ = tsk.sinkhorn_plain(t1, w1, t2, w2, **kw)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)


def test_engine_on_the_card_matches_the_cpu(cuda):
    c = make_corpus(CorpusSpec(n_docs=300, vocab_size=800, emb_dim=64,
                               h_max=16, mean_h=8.0, n_classes=4, seed=7),
                    device="cpu")
    cpu = tlc.LCRWMDEngine(c.docs, c.emb, device="cpu")
    gpu = tlc.LCRWMDEngine(c.docs, c.emb)
    assert gpu.device.type == "cuda"
    q = c.docs[:8]
    atol = 4.0 * float(np.sqrt(2.0 ** -23 * float((cpu.emb_full ** 2).sum(1).max())))
    for method in ("one_sided", "symmetric"):
        torch.testing.assert_close(getattr(gpu, method)(q).cpu(),
                                   getattr(cpu, method)(q), rtol=1e-4, atol=atol)
    for method in ("topk_streaming", "symmetric_topk_streaming"):
        a, b = getattr(gpu, method)(q, 10), getattr(cpu, method)(q, 10)
        torch.testing.assert_close(a.dists.cpu(), b.dists, rtol=1e-4, atol=atol)
    res = tpipe.pruned_wmd_topk(c.docs, q, c.emb, k=5, engine=gpu,
                                sinkhorn_kw=dict(eps=0.05, eps_scaling=2,
                                                 max_iters=100))
    assert torch.equal(res.topk.indices[:, 0].cpu(), torch.arange(8, dtype=torch.int32))


def test_spmm_dense_and_naive_kernels_match_plain(cuda):
    from repro_torch.kernels import spmm_ell as sp

    rng = np.random.default_rng(4)
    # (.., 160, ..): rows wider than 64 slots (the dense kernel's shared-
    # memory path); "skewed": every slot in one vocab subtile; "pad": all-
    # zero rows; n is not a multiple of the dense kernel's 8 rows a CTA
    for n, h, v, b, kind in ((5000, 48, 1500, 64, ""), (777, 13, 600, 70, ""),
                             (33, 40, 513, 5, ""), (301, 160, 4000, 64, ""),
                             (1003, 48, 2000, 64, "skewed"),
                             (515, 48, 2000, 33, "pad")):
        ids, w = _ell(rng, n, h, v)
        if kind == "skewed":              # all in subtile 2 of 2000 // 512
            ids = torch.tensor(rng.integers(2 * sp.DENSE_BV, 3 * sp.DENSE_BV,
                                            size=(n, h)).astype(np.int32))
        if kind == "pad":
            w[::3] = 0.0
        ids, w = ids.to(cuda), w.to(cuda)
        z = torch.tensor(rng.normal(size=(v, b)).astype(np.float32)).to(cuda)
        plain = sp.spmm_ell_plain(ids, w, z)
        torch.testing.assert_close(sp.spmm_ell_dense_cuda(ids, w, z),
                                   sp.spmm_ell_dense_plain(ids, w, z),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(sp.spmm_ell_dense_cuda(ids, w, z), plain,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(sp.spmm_ell_naive_cuda(ids, w, z),
                                   sp.spmm_ell_naive_plain(ids, w, z),
                                   rtol=1e-5, atol=1e-5)
        # the seed kernel takes the blocked kernel's fmaf chain: bit-equal
        assert torch.equal(sp.spmm_ell_naive_cuda(ids, w, z),
                           sp.spmm_ell_cuda(ids, w, z))
        if kind == "pad":
            assert not sp.spmm_ell_dense_cuda(ids, w, z)[::3].any()


def test_spmm_dense_kernel_adds_nothing_for_out_of_range_ids(cuda):
    """A slot whose id lies outside [0, v) adds nothing, as in the one-hot
    product of the plain version (the register and shared-memory paths)."""
    from repro_torch.kernels import spmm_ell as sp

    rng = np.random.default_rng(5)
    for n, h, v, b in ((1000, 48, 1500, 64), (203, 160, 3000, 40)):
        ids, w = _ell(rng, n, h, v)
        out = torch.tensor(rng.random(size=(n, h)) < 0.2)
        bad = torch.tensor(rng.choice([-1, -(2**31), v, v + 700, 2**31 - 1],
                                      size=(n, h)).astype(np.int32))
        ids_bad = torch.where(out, bad, ids)
        w_in = torch.where(out, torch.zeros_like(w), w)
        ids_bad, w, w_in = ids_bad.to(cuda), w.to(cuda), w_in.to(cuda)
        z = torch.tensor(rng.normal(size=(v, b)).astype(np.float32)).to(cuda)
        got = sp.spmm_ell_dense_cuda(ids_bad, w, z)
        torch.testing.assert_close(got, sp.spmm_ell_dense_plain(ids_bad, w, z),
                                   rtol=1e-5, atol=1e-5)
        # the same sums as with those slots' weights set to 0
        assert torch.equal(got, sp.spmm_ell_dense_cuda(ids_bad, w_in, z))


def test_fused_chunk_kernel_matches_plain(cuda):
    from repro_torch.kernels import fused_stream as fs

    g = torch.Generator().manual_seed(5)
    for cv, b, h, m, n, h1 in ((512, 64, 48, 300, 3000, 48),
                               (100, 7, 9, 64, 500, 12)):
        emb_c = torch.randn(cv, m, generator=g).to(cuda)
        t = torch.randn(b, h, m, generator=g).to(cuda)
        valid = (torch.rand(b, h, generator=g) > 0.3).float().to(cuda)
        lo = 2 * cv  # ids span the chunk [lo, lo + cv) and both sides of it
        ids = torch.randint(lo - cv, lo + 2 * cv, (n, h1), generator=g)
        ids = ids.to(torch.int32).to(cuda)
        w = torch.rand(n, h1, generator=g).to(cuda)
        d0 = torch.rand(n, b, generator=g).to(cuda)
        for bf16 in (False, True):
            got = fs.fused_chunk_cuda(emb_c, t, valid, ids, w, lo, d0.clone(),
                                      bf16_matmul=bf16)
            want = fs.fused_chunk_plain(emb_c, t, valid, ids, w, lo,
                                        d0.clone(), bf16_matmul=bf16)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
    with pytest.raises(ValueError, match="exceeds"):
        fs.fused_chunk_cuda(torch.zeros(2048, m, device=cuda), t, valid,
                            ids, w, 0, torch.zeros(n, b, device=cuda))


def test_rwmd_pairwise_kernel_matches_plain(cuda):
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwmd_pairwise as rw

    rng = np.random.default_rng(6)
    # (.., 160, ..) and (.., 300, ..): docs of more than 128 words, taken in
    # row tiles; (.., 1100, ..): a query of more than 1,024 words
    for n, h1, b, h2, m in ((301, 48, 64, 48, 300), (77, 16, 5, 9, 64),
                            (40, 100, 3, 128, 32), (50, 160, 64, 160, 300),
                            (23, 300, 5, 7, 64), (30, 12, 3, 1100, 32)):
        v = 900
        emb = torch.tensor(rng.normal(size=(v, m)).astype(np.float32)).to(cuda)
        r_ids, r_w = (x.to(cuda) for x in _ell(rng, n, h1, v))
        q_ids, q_w = (x.to(cuda) for x in _ell(rng, b, h2, v))
        r_w[0] = 0.0   # an empty resident doc
        q_w[-1] = 0.0  # an empty query
        for bf16 in (True, False):
            got = rw.rwmd_pairwise_cuda(emb, r_ids, r_w, q_ids, q_w,
                                        bf16_matmul=bf16)
            want = rw.rwmd_pairwise_plain(emb, r_ids, r_w, q_ids, q_w,
                                          bf16_matmul=bf16)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
        # the empty doc and the empty query give the 3.4e38 sentinel
        assert float(got[0, 0]) > 3e38 and float(got[1, -1]) > 3e38
        oracle = torch.stack([ref.rwmd_pairwise_ref(
            emb[r_ids.long()], r_w, emb[q_ids[j].long()], q_w[j])
            for j in range(b - 1)], dim=1)
        torch.testing.assert_close(got[1:, :b - 1], oracle[1:], rtol=1e-4,
                                   atol=1e-2)


FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, True),
    (1, 512, 512, 8, 8, 32, True),     # MHA
    (2, 256, 256, 4, 1, 64, True),     # MQA
    (1, 256, 256, 4, 2, 128, False),   # bidirectional, dh 128
    (1, 300, 300, 32, 8, 64, True),    # llama3.2-1b heads, not a tile multiple
    (2, 77, 130, 6, 2, 64, False),     # T != S, group 3
    (1, 100, 100, 12, 3, 128, True),   # dh 128, group 4
    # ragged KV tails: S != T, T not a multiple of the 64-key tile
    (1, 96, 100, 4, 2, 32, False),
    (2, 150, 201, 8, 2, 64, False),
    (1, 60, 131, 4, 1, 128, False),
    (1, 200, 137, 8, 2, 64, True),     # causal with fewer keys than rows
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, b, s, t, hq, hkv, dh,
                                              causal, dtype):
    g = torch.Generator().manual_seed(s * 7 + dh)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype)
               for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh)))
    got = tfa.flash_attention_cuda(q, k, v, causal=causal)
    want = tfa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:   # only the order of the sums differs
        err = (got - want).abs().max().item()
        assert err <= 1e-4, err
    else:   # p rounded against the running max here, the row's max there
        gap = tfa.bf16_gap(got, want)
        assert gap["ok"], gap


def test_flash_attention_kernel_rounds_p_to_bf16(cuda):
    q, k, v, want = tfa.p_rounding_probe(device=cuda)
    assert torch.equal(tfa.flash_attention_cuda(q, k, v, causal=False), want)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 64, 4, 48, device=cuda)
    k = torch.zeros(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention_cuda(q, k, k)
    q = torch.zeros(1, 64, 4, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_cuda(q, q, q)


def test_segment_spmm_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(9)
    n, e, d = 5000, 60000, 100
    alive = torch.rand(n - 1, generator=g) >= 0.05     # some degree-0 rows
    cand = alive.nonzero()[:, 0].to(torch.int32)
    dst = torch.sort(cand[torch.randint(0, cand.numel(), (e,), generator=g)]).values
    dst = torch.cat([dst, torch.full((300,), n - 1, dtype=torch.int32)])  # sink
    src = torch.randint(0, n, (dst.numel(),), generator=g, dtype=torch.int32)
    rad = torch.rand(dst.numel(), generator=g) * 0.9 + 0.1
    rad[e:] = 0.0
    feat = torch.randn(n, d, generator=g)
    want = tseg.segment_spmm_plain(src, dst, feat, rad, n)   # CPU: edge order
    got = tseg.segment_spmm_cuda(src.to(cuda), dst.to(cuda), feat.to(cuda),
                                 rad.to(cuda), n).cpu()
    # the same products and sums in the same (ascending edge) order
    assert torch.equal(got, want)
    assert bool((got[:-1][~alive] == 0).all()) and bool((got[-1] == 0).all())


def test_transformer_prefill_runs_b8_and_matches_plain_attention(cuda,
                                                                monkeypatch):
    cfg = tconfig.TransformerConfig(
        name="small", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=1000, rope_theta=10_000.0, dtype="float32",
        max_seq_len=256)
    params = TM.init_params(cfg, seed=0, device=cuda)
    tokens = torch.randint(0, 1000, (2, 150), device=cuda)
    _build.reset_launches()
    got, cache = TM.forward_with_cache(params, tokens, cfg, 160)
    assert _build.LAUNCHES["flash_attention"] == cfg.n_layers
    # the plain attention in B8's place: the reference's route
    monkeypatch.setattr(TM, "flash_attention", lambda q, k, v, *, causal=True:
                        gqa_attention(q, k, v, causal=causal))
    want, cache_p = TM.forward_with_cache(params, tokens, cfg, 160)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache.k, cache_p.k, rtol=1e-4, atol=1e-4)
    lg, _ = TM.decode_step(params, cache, tokens[:, :1], cfg)
    assert lg.shape == (2, 1, 1000) and bool(torch.isfinite(lg).all())
