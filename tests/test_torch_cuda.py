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
    # above the shared-memory carry's 128: the global carry, no refusal
    v, i = tfs.phase2_topk_cuda(ids, w, z, 129)
    pv, pi = tfs.phase2_topk_plain(ids, w, z, 129, row_block=1024)
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
    assert torch.equal(v, d.T.gather(1, i.long()))
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
        ids.data_ptr(), w.data_ptr(), z.data_ptr(), 0, 0, 0, vals.data_ptr(),
        idx.data_ptr(), n, n_real, h, z.shape[0], b, k, rows,
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


def _gap_clear(pv, tol=1e-4):
    """Slots whose value is more than tol from both neighbours' (B, k)."""
    clear = torch.ones_like(pv, dtype=torch.bool)
    step = pv[:, 1:] - pv[:, :-1] > tol
    clear[:, 1:] &= step
    clear[:, :-1] &= step
    return clear


def _assert_topk_matches_plain(v, i, pv, pi, tol=1e-4):
    """Values within 1e-5 (the plain sums run in another order), ids equal
    wherever the gaps exceed tol; the plain fold's unfilled slots (+inf,
    -1) are the kernel's (3.4e38, -1)."""
    big = torch.tensor(tp1.BIG, dtype=torch.float32, device=pv.device)
    dropped = pi < 0
    pv = torch.where(dropped, big, pv)
    pi = torch.where(dropped, -1, pi)
    torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)
    clear = _gap_clear(pv, tol)
    assert torch.equal(i[clear], pi[clear])


@pytest.mark.parametrize("k", [129, 256, 1000, 5000])
def test_fused_topk_kernel_any_k(cuda, k):
    """k above the shared-memory carry: the carry in global memory.  5,000
    exceeds n_real = 3,000: every row is ranked."""
    rng = np.random.default_rng(k)
    ids, w = (x.to(cuda) for x in _ell(rng, 20_000, 48, 900))
    z = torch.tensor(np.abs(rng.normal(size=(900, 70))).astype(np.float32)).to(cuda)
    n_real = 3000 if k == 5000 else None
    d = tsp.spmm_ell_cuda(ids, w, z)
    v, i = tfs.phase2_topk_cuda(ids, w, z, k, n_real=n_real)
    pv, pi = tfs.phase2_topk_plain(ids, w, z, k, n_real=n_real,
                                   row_block=4096)
    assert v.shape == (70, min(k, n_real or k))
    _assert_topk_matches_plain(v, i, pv, pi)
    assert torch.equal(v, d.T.gather(1, i.long()))  # B2's D, bit for bit
    if n_real is not None:
        assert torch.equal(i.sort(dim=1).values,
                           torch.arange(n_real, dtype=torch.int32,
                                        device=cuda).expand(70, -1))


@pytest.mark.parametrize("k", [49_000, 50_000])
def test_fused_topk_kernel_k_near_n_real_many_ctas(cuda, k):
    """k close to and equal to n_real = 50,000 over the card's full grid of
    CTAs (a few hundred rows each): each CTA's partial is as wide as its
    rows, not k, and the merges widen the lists to k, so the call's memory
    stays a few times n_real x B entries."""
    rng = np.random.default_rng(k)
    n, b = 50_000, 8
    ids, w = (x.to(cuda) for x in _ell(rng, n, 48, 900))
    z = torch.tensor(np.abs(rng.normal(size=(900, b))).astype(np.float32)).to(cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    rows, n_ctas = tfs.cta_rows(n, n_sm)
    assert n_ctas > 64 and tfs.list_widths(k, rows, n_ctas)[0] == rows < k
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    v, i = tfs.phase2_topk_cuda(ids, w, z, k)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(cuda) - base
    assert extra <= 4 * n * b * 8, extra
    pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=65536)
    assert v.shape == (b, k)
    _assert_topk_matches_plain(v, i, pv, pi)
    assert torch.equal(v, tsp.spmm_ell_cuda(ids, w, z).T.gather(1, i.long()))
    if k == n:
        assert torch.equal(i.sort(dim=1).values,
                           torch.arange(n, dtype=torch.int32,
                                        device=cuda).expand(b, -1))


def test_fused_topk_kernel_z_past_2_31_entries(cuda):
    """Z of more than 2^31 entries (8.6 GB): the kernel's 64-bit offset
    variant (WIDE, only taken there) reaches the rows past that mark,
    against the plain fold."""
    rng = np.random.default_rng(31)
    b = 64
    v = 2 ** 31 // b + 4096
    ids, w = _ell(rng, 2000, 16, v)
    ids[:, ::2] = torch.tensor(rng.integers(v - 8192, v, size=(2000, 8)),
                               dtype=torch.int32)   # rows past 2^31 / B
    ids, w = ids.to(cuda), w.to(cuda)
    g = torch.Generator(device=cuda).manual_seed(31)
    z = torch.rand((v, b), generator=g, device=cuda)
    assert z.numel() >= 2 ** 31
    for k in (32, 200):
        v_k, i_k = tfs.phase2_topk_cuda(ids, w, z, k)
        pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=4096)
        _assert_topk_matches_plain(v_k, i_k, pv, pi)
    del z
    torch.cuda.empty_cache()


def test_fused_topk_kernel_many_queries(cuda):
    """B = 70,000 queries, more than a grid dimension's 65,535 (the merge
    launches one CTA per (pair, query)), on a small corpus, at k = 32 and
    200."""
    rng = np.random.default_rng(70)
    ids, w = (x.to(cuda) for x in _ell(rng, 3000, 16, 500))
    z = torch.tensor(np.abs(rng.normal(size=(500, 70_000))).astype(np.float32)).to(cuda)
    for k in (32, 200):
        v, i = tfs.phase2_topk_cuda(ids, w, z, k)
        pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=250)
        _assert_topk_matches_plain(v, i, pv, pi)


def test_fused_topk_kernel_masks_and_d21(cuda):
    """row_valid (tombstones), q_gid (self-exclusion) and the d21 operand
    against the plain fold; an all-True mask equals None; with all rows
    tombstoned but k, exactly the k live rows come back."""
    rng = np.random.default_rng(16)
    n, b = 20_000, 70
    ids, w = (x.to(cuda) for x in _ell(rng, n, 48, 900))
    z = torch.tensor(np.abs(rng.normal(size=(900, b))).astype(np.float32)).to(cuda)
    live = torch.tensor(rng.random(n) > 0.3).to(cuda)
    gid = torch.tensor(rng.integers(0, n, b).astype(np.int32)).to(cuda)
    d21 = torch.tensor(np.abs(rng.normal(size=(n, b)) * 8).astype(np.float32)).to(cuda)
    for k in (32, 256):
        for kw in (dict(row_valid=live), dict(q_gid=gid), dict(d21=d21),
                   dict(row_valid=live, q_gid=gid, d21=d21)):
            v, i = tfs.phase2_topk_cuda(ids, w, z, k, **kw)
            pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=4096, **kw)
            _assert_topk_matches_plain(v, i, pv, pi)
            if "row_valid" in kw:
                assert bool(live[i.long()].all())
            if "q_gid" in kw:
                assert not bool((i == gid[:, None]).any())
        a = tfs.phase2_topk_cuda(ids, w, z, k)
        t = tfs.phase2_topk_cuda(ids, w, z, k,
                                 row_valid=torch.ones(n, dtype=torch.bool,
                                                      device=cuda))
        assert torch.equal(a[0], t[0]) and torch.equal(a[1], t[1])
    few = torch.zeros(n, dtype=torch.bool, device=cuda)
    keep = torch.tensor(rng.choice(n, 40, replace=False)).to(cuda)
    few[keep] = True
    v, i = tfs.phase2_topk_cuda(ids, w, z, 40, row_valid=few)
    assert torch.equal(i.sort(dim=1).values,
                       keep.sort().values.to(torch.int32).expand(b, -1))
    pv, pi = tfs.phase2_topk_plain(ids, w, z, 40, row_block=4096, row_valid=few)
    _assert_topk_matches_plain(v, i, pv, pi)


# (pairs, h1, h2, m, share of padded words, solver settings): the warp-per-
# pair route (both widths <= 48) and the CTA-per-pair route on either side
# of the split, Table IV set 1's h = 160, more rows or columns than the
# CTA's 256 threads (long docs against short queries, and the reverse),
# bf16, no iteration, empty pairs
SINKHORN_CASES = {
    "h12x10": (64, 12, 10, 300, 0.3, None),   # every CONFIGS entry
    "h48": (300, 48, 48, 300, 0.43, "rerank"),
    "h49x48": (64, 49, 48, 300, 0.43, "rerank"),
    "h48x49": (64, 48, 49, 300, 0.43, "rerank"),
    "h160": (32, 160, 160, 300, 0.3, "rerank"),
    "h400x32": (32, 400, 32, 300, 0.3, "rerank"),
    "h32x400": (32, 32, 400, 300, 0.3, "rerank"),
    "bf16": (128, 48, 48, 300, 0.43, "rerank"),
    "max_iters_0": (128, 48, 48, 300, 0.43, "none"),
    "empty": (64, 48, 48, 300, 0.43, "rerank"),
    "m70": (64, 20, 30, 70, 0.3, "rerank"),    # rows read as 4-byte words
}
RERANK_KW = dict(eps=0.05, eps_scaling=2, max_iters=100)


@pytest.mark.parametrize("case", list(SINKHORN_CASES))
def test_sinkhorn_kernel_matches_plain(cuda, case):
    p, h1, h2, m, pad, kw = SINKHORN_CASES[case]
    g = torch.Generator().manual_seed(3 + h1 + h2 + p)
    w1 = torch.rand(p, h1, generator=g) * (torch.rand(p, h1, generator=g) > pad)
    w2 = torch.rand(p, h2, generator=g) * (torch.rand(p, h2, generator=g) > pad)
    w1[:, 0] += 0.1
    w2[:, 0] += 0.1
    if case == "empty":  # no valid row, no valid column, neither
        w1[0::3] = 0.0
        w2[1::3] = 0.0
        w2[0::6] = 0.0
    w1 = w1 / w1.sum(1, keepdim=True).clamp(min=1e-30)
    w2 = w2 / w2.sum(1, keepdim=True).clamp(min=1e-30)
    t1 = torch.randn(p, h1, m, generator=g)
    t2 = torch.randn(p, h2, m, generator=g)
    t1, w1, t2, w2 = (x.to(cuda) for x in (t1, w1, t2, w2))
    bf16 = case == "bf16"
    kws = (CONFIGS if kw is None else
           [dict(RERANK_KW, max_iters=0)] if kw == "none" else [RERANK_KW])
    _build.reset_launches()
    for k in kws:
        got, it = tsk.sinkhorn_cuda(t1, w1, t2, w2, bf16_matmul=bf16, **k)
        want, want_it = tsk.sinkhorn_plain(t1, w1, t2, w2, bf16_matmul=bf16, **k)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-4)
        empty = ((w1 > 0).sum(1) == 0) | ((w2 > 0).sum(1) == 0)
        assert bool((got[empty] == 0).all())
        fixed = empty | (k["max_iters"] == 0)
        assert torch.equal(it[fixed], want_it[fixed])
    assert _build.LAUNCHES[tsk.NAME] == len(kws)
    if case == "h48":  # the wrapper refuses a tile over shared memory
        with pytest.raises(ValueError, match="shared memory"):
            tsk.sinkhorn_cuda(*(torch.zeros(2, 257, 8, device=cuda),
                                torch.ones(2, 257, device=cuda)) * 2)


def test_pruned_wmd_topk_with_an_engine_copies_nothing_to_the_card(cuda):
    """With an engine the rerank reads the engine's device tensors: one call,
    given the embeddings as a host numpy array (as chip_smoke.py gives
    them), makes no host-to-device copy (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    c = make_corpus(CorpusSpec(n_docs=2000, vocab_size=3000, emb_dim=300,
                               h_max=48, mean_h=27.5, n_classes=4, seed=11),
                    device="cpu")
    emb = np.asarray(c.emb, dtype=np.float32)
    assert isinstance(emb, np.ndarray)
    eng = tlc.LCRWMDEngine(c.docs, emb)
    docs = c.docs.to(cuda)
    q = docs[:16]
    kw = dict(k=5, engine=eng, sinkhorn_kw=RERANK_KW)
    first = tpipe.pruned_wmd_topk(docs, q, emb, **kw)  # builds and warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = tpipe.pruned_wmd_topk(docs, q, emb, **kw)
        torch.cuda.synchronize()
    copies = [e.key for e in prof.key_averages() if "HtoD" in e.key]
    assert not copies, copies
    assert torch.equal(res.topk.indices, first.topk.indices)
    cpu = tpipe.pruned_wmd_topk(c.docs, c.docs[:16], emb, k=5,
                                engine=tlc.LCRWMDEngine(c.docs, emb, device="cpu"),
                                sinkhorn_kw=RERANK_KW)
    assert torch.equal(res.topk.indices[:, 0].cpu(), cpu.topk.indices[:, 0])


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


# (cv, B, h, m, n, h1): Z in shared memory (cv * B floats fit) or read from
# L2, one or two query slabs, rows read as 16-byte vectors or as words
FUSED_CHUNK_CASES = {
    "cv64_b1": (64, 1, 48, 300, 3000, 48),
    "cv512_b64": (512, 64, 48, 300, 3000, 48),   # the slice's chunk
    "cv512_b65": (512, 65, 48, 300, 3000, 48),
    "cv1024_b128": (1024, 128, 48, 300, 3000, 48),  # Z from L2
    "cv2048_b64": (2048, 64, 48, 300, 3000, 48),    # past the old 1,024 cap
    "b200": (512, 200, 20, 64, 2000, 48),           # two slabs of queries
    "ragged": (100, 7, 9, 64, 500, 13),             # ids read as words
}


@pytest.mark.parametrize("case", list(FUSED_CHUNK_CASES))
def test_fused_chunk_kernel_matches_plain(cuda, case):
    from repro_torch.kernels import fused_stream as fs

    cv, b, h, m, n, h1 = FUSED_CHUNK_CASES[case]
    g = torch.Generator().manual_seed(5 + cv + b)
    emb_c = torch.randn(cv, m, generator=g).to(cuda)
    t = torch.randn(b, h, m, generator=g).to(cuda)
    valid = (torch.rand(b, h, generator=g) > 0.3).float()
    valid[b // 2] = 0.0  # a query with no valid word: Z = sqrt(3.4e38)
    valid = valid.to(cuda)
    lo = 2 * cv  # ids span the chunk [lo, lo + cv) and both sides of it
    ids = torch.randint(lo - cv, lo + 2 * cv, (n, h1), generator=g)
    ids = ids.to(torch.int32).to(cuda)
    w = torch.rand(n, h1, generator=g)
    w = (w * (torch.rand(n, h1, generator=g) > 0.3)).to(cuda)
    d0 = torch.rand(n, b, generator=g).to(cuda)
    for bf16 in (False, True):
        got = fs.fused_chunk_cuda(emb_c, t, valid, ids, w, lo, d0.clone(),
                                  bf16_matmul=bf16)
        want = fs.fused_chunk_plain(emb_c, t, valid, ids, w, lo, d0.clone(),
                                    bf16_matmul=bf16)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
    # a chunk that no row touches leaves D as it was, bit for bit; each
    # slab of CHUNK_COLS queries counts its two kernels
    away = torch.where((ids >= lo) & (ids < lo + cv), ids - cv, ids)
    _build.reset_launches()
    got = fs.fused_chunk_cuda(emb_c, t, valid, away, w, lo, d0.clone())
    assert torch.equal(got, d0)
    assert _build.LAUNCHES[fs.CHUNK_NAME] == 2 * -(-b // fs.CHUNK_COLS)


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


# (n, h1, B, h2, m): docs straddling row tiles at the slice's widths; docs
# of 160 words (Table IV set 1) spanning three tiles; 2-word docs, so the
# 16-docs-a-tile cut sets the tiles; a ragged m (4-byte copies); 70 queries
# (three groups of 32).
D21_CASES = [(3001, 48, 64, 48, 300), (500, 160, 64, 160, 300),
             (4000, 3, 9, 5, 64), (700, 20, 70, 30, 70)]


@pytest.mark.parametrize("case", D21_CASES)
def test_rwmd_kernel_modes_match_plain(cuda, case):
    """B7 in both modes against its plain versions (f32 and bf16), with an
    empty resident doc and an empty query."""
    from repro_torch.kernels import rwmd_pairwise as rw

    n, h1, b, h2, m = case
    rng = np.random.default_rng(n + h1)
    v = 2000
    emb = torch.tensor(rng.normal(size=(v, m)).astype(np.float32)).to(cuda)
    r_ids, r_w = (x.to(cuda) for x in _ell(rng, n, h1, v))
    q_ids, q_w = (x.to(cuda) for x in _ell(rng, b, h2, v))
    r_w[1] = 0.0   # an empty resident doc
    q_w[2] = 0.0   # an empty query
    for bf16 in (False, True):
        got = rw.rwmd_d21_cuda(emb, r_ids, r_w, q_ids, q_w, bf16_matmul=bf16)
        want = rw.rwmd_d21_plain(emb, r_ids, r_w, q_ids, q_w, bf16_matmul=bf16)
        assert not bool(torch.isnan(got).any())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
        # the empty doc: +inf against every query with a word, 0 against none
        assert bool(torch.isinf(got[1][(q_w > 0).any(1)]).all())
        assert bool((got[:, 2] == 0).all())
        got = rw.rwmd_pairwise_cuda(emb, r_ids, r_w, q_ids, q_w,
                                    bf16_matmul=bf16)
        want = rw.rwmd_pairwise_plain(emb, r_ids, r_w, q_ids, q_w,
                                      bf16_matmul=bf16)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)


def test_symmetric_topk_streaming_on_the_card_matches_the_cpu(cuda):
    """B1 + B7's d21 mode + B3 against the CPU slab fold: values within the
    gram tolerance, ids equal wherever the gaps exceed it; k above 128 and
    an empty resident doc included."""
    c = make_corpus(CorpusSpec(n_docs=3000, vocab_size=2000, emb_dim=300,
                               h_max=48, mean_h=27.5, n_classes=4, seed=16),
                    device="cpu")
    c.docs.weights[5] = 0.0   # an empty resident doc (not a query)
    cpu = tlc.LCRWMDEngine(c.docs, c.emb, device="cpu", row_block=512)
    gpu = tlc.LCRWMDEngine(c.docs, c.emb)
    q = c.docs[10:50]
    atol = 4.0 * float(np.sqrt(2.0 ** -23 * float((cpu.emb_full ** 2).sum(1).max())))
    _build.reset_launches()
    for k in (20, 300):
        a = gpu.symmetric_topk_streaming(q, k)
        b = cpu.symmetric_topk_streaming(q, k)
        ad, ai, bd, bi = a.dists.cpu(), a.indices.cpu(), b.dists, b.indices
        torch.testing.assert_close(ad, bd, rtol=1e-4, atol=atol)
        clear = _gap_clear(bd, atol)
        assert torch.equal(ai[clear], bi[clear])
        assert not bool((ai == 5).any())
    assert _build.LAUNCHES["rwmd_d21"] == 2 and _build.LAUNCHES["fused_topk"] == 2
    # the cascade at a rerank budget of 200: its candidates through B3 at
    # k = 200 match the CPU's; the empty doc, at WMD 0 to every query, comes
    # first on both (the rerank's Sinkhorn values themselves stop at
    # max_iters and part ways, as the reference's two backends do)
    a = gpu.topk_streaming(q, 200)
    b = cpu.topk_streaming(q, 200)
    torch.testing.assert_close(a.dists.cpu(), b.dists, rtol=1e-4, atol=atol)
    assert torch.equal(a.indices.cpu()[_gap_clear(b.dists, atol)],
                       b.indices[_gap_clear(b.dists, atol)])
    kw = dict(rerank_budget=200, sinkhorn_kw=dict(eps=0.05, eps_scaling=2,
                                                  max_iters=100))
    a = tpipe.cascade_topk(gpu, q, 5, **kw)
    b = tpipe.cascade_topk(cpu, q, 5, **kw)
    assert bool((a.indices[:, 0] == 5).all()) and bool((b.indices[:, 0] == 5).all())


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
    # grok-1's heads: group 6 at dh 128 (two heads a CTA), ragged S
    (1, 333, 333, 48, 8, 128, True),
    (1, 200, 333, 48, 8, 128, False),
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


def _graph(g, n, e, *, hub=0, first_empty=False, sink=300, isolated=0.05):
    """Edges sorted by dst: uniform rows but a share of degree-0 rows, an
    optional hub row of ``hub`` more edges, row 0 without an edge if
    ``first_empty``, and ``sink`` padding edges (rad 0) to the last row."""
    alive = torch.rand(n - 1, generator=g) >= isolated
    if first_empty:
        alive[0] = False
    cand = alive.nonzero()[:, 0].to(torch.int32)
    dst = cand[torch.randint(0, cand.numel(), (e,), generator=g)]
    if hub:
        dst = torch.cat([dst, cand[cand.numel() // 2].repeat(hub)])
    dst = torch.cat([torch.sort(dst).values,
                     torch.full((sink,), n - 1, dtype=torch.int32)])
    src = torch.randint(0, n, (dst.numel(),), generator=g, dtype=torch.int32)
    rad = torch.rand(dst.numel(), generator=g) * 0.9 + 0.1
    rad[dst.numel() - sink:] = 0.0
    return src, dst, rad, alive


@pytest.mark.parametrize("d", [1, 3, 100, 128, 129, 256])
def test_segment_spmm_kernel_bit_equal_at_any_width(cuda, d):
    """Degree-0 rows, a hub row of 50,000 edges, the sink row's padding
    edges and a first row with no edge, at widths of both routes (16-byte
    loads where d % 4 == 0), each bit-equal to the CPU plain version."""
    g = torch.Generator().manual_seed(d)
    n = 3000
    src, dst, rad, alive = _graph(g, n, 40_000, hub=50_000, first_empty=True)
    feat = torch.randn(n, d, generator=g)
    want = tseg.segment_spmm_plain(src, dst, feat, rad, n)
    args = [x.to(cuda) for x in (src, dst, feat, rad)]
    got = tseg.segment_spmm_cuda(*args, n).cpu()
    assert torch.equal(got, want)
    assert not got[0].any() and not got[-1].any()
    assert not got[:-1][~alive].any()


def test_segment_spmm_kernel_edges_near_the_int32_limit(cuda):
    """E = 2^31 - 1 edges, 32 a row: the last warp's look-ahead passes
    2^31 and must not wrap round (src, dst and rad take 25.8 GB)."""
    e = 2**31 - 1
    dst = torch.arange(e, dtype=torch.int32, device=cuda).div_(
        32, rounding_mode="floor")
    n = int(dst[-1]) + 1
    src = torch.zeros(e, dtype=torch.int32, device=cuda)
    rad = torch.ones(e, device=cuda)
    got = tseg.segment_spmm_cuda(src, dst, torch.ones((1, 1), device=cuda),
                                 rad, n)
    del src, dst, rad
    want = torch.full((n, 1), 32.0, device=cuda)
    want[-1] = e % 32
    assert torch.equal(got, want)


def test_segment_spmm_kernel_scalar_route_and_empty_graphs(cuda):
    """A feat 16-byte misaligned takes the 4-byte route at D = 100; a graph
    whose edges reach only the last row, and one with no edge at all."""
    g = torch.Generator().manual_seed(3)
    n, d = 2000, 100
    src, dst, rad, _ = _graph(g, n, 20_000)
    buf = torch.randn(n * d + 1, generator=g)
    feat = buf.to(cuda)[1:].view(n, d)
    assert tseg.vector_width(d, feat.data_ptr()) == 1
    want = tseg.segment_spmm_plain(src, dst, buf[1:].view(n, d), rad, n)
    got = tseg.segment_spmm_cuda(src.to(cuda), dst.to(cuda), feat,
                                 rad.to(cuda), n)
    assert torch.equal(got.cpu(), want)
    feat = torch.randn(n, d, generator=g)
    for src, dst, rad in (
            (torch.arange(5, dtype=torch.int32), torch.full((5,), n - 1,
             dtype=torch.int32), torch.ones(5)),
            (torch.zeros(0, dtype=torch.int32),) * 2 + (torch.zeros(0),)):
        want = tseg.segment_spmm_plain(src, dst, feat, rad, n)
        got = tseg.segment_spmm_cuda(src.to(cuda), dst.to(cuda), feat.to(cuda),
                                     rad.to(cuda), n).cpu()
        assert torch.equal(got, want)


def _blocked_case(rng, n, h, v, b):
    """An ELL set with rows of no valid slot, ids 0 and v - 1 in use, and a
    Z that is finite; padding slots anywhere in a row."""
    ids, w = _ell(rng, n, h, v, pad=0.5)
    ids[::5, 0], ids[1::5, -1] = 0, v - 1
    w[::7] = 0.0                      # rows with no valid slot
    z = torch.tensor(rng.normal(size=(v, b)).astype(np.float32))
    return ids, w, z


@pytest.mark.parametrize("h", [1, 31, 33, 48, 160])
@pytest.mark.parametrize("b", [1, 20, 64, 65, 130])
def test_spmm_blocked_kernel_bit_equal_to_naive_and_fused_topk(cuda, b, h):
    """B2 at every lane plan (1, 2 or 4 columns a lane, vector or 4-byte
    loads, column chunks past 128) and ELL widths of one, two and three
    64-slot pieces: within 1e-5 of the plain version, bit-equal to the seed
    kernel (B6b) and to the fused top-k's values (B3)."""
    rng = np.random.default_rng(b * 1000 + h)
    ids, w, z = (x.to(cuda) for x in _blocked_case(rng, 4001, h, 900, b))
    d = tsp.spmm_ell_cuda(ids, w, z)
    torch.testing.assert_close(d, tsp.spmm_ell_plain(ids, w, z), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(d, tsp.spmm_ell_naive_cuda(ids, w, z))
    assert not d[::7].any()
    v, i = tfs.phase2_topk_cuda(ids, w, z, 16)
    assert torch.equal(v, d.T.gather(1, i.long()))


def test_spmm_blocked_kernel_unaligned_z_and_chunk_shape(cuda):
    """A Z 8-byte misaligned at B = 64 (2 columns a lane, 4-byte loads), and
    the vocabulary-chunk call's shape: chunk-relative ids into a Z of
    (512, 64), most slots zero-weight."""
    rng = np.random.default_rng(11)
    ids, w, z = _blocked_case(rng, 3000, 48, 900, 64)
    ids, w = ids.to(cuda), w.to(cuda)
    buf = torch.zeros(900 * 64 + 1, device=cuda)
    zu = buf[1:].view(900, 64)
    zu.copy_(z.to(cuda))
    assert tsp.column_plan(64, zu.data_ptr()) == (2, False)
    d = tsp.spmm_ell_cuda(ids, w, zu)
    assert torch.equal(d, tsp.spmm_ell_naive_cuda(ids, w, zu))
    assert torch.equal(d, tsp.spmm_ell_cuda(ids, w, z.to(cuda)))
    r_ids = torch.tensor(rng.integers(0, 73_123, size=(20_000, 48)).astype(
        np.int32), device=cuda)
    r_w = torch.rand(20_000, 48, device=cuda)
    zc = torch.rand(512, 64, device=cuda)
    c_ids, c_w = tfs.chunk_relative(r_ids, r_w, 36_352, 512)
    d = tsp.spmm_ell_cuda(c_ids, c_w, zc)
    assert torch.equal(d, tsp.spmm_ell_naive_cuda(c_ids, c_w, zc))
    torch.testing.assert_close(d, tsp.spmm_ell_plain(c_ids, c_w, zc),
                               rtol=1e-5, atol=1e-5)


def _naive_vs_blocked(ids, w, z):
    """B6b's D, bit-equal to B2's on the same inputs (contiguous copies for
    B2), and within the sum's rounding (1e-5 of Σ|w·z| a row and column)
    of its plain version."""
    d = tsp.spmm_ell_naive_cuda(ids, w, z)
    assert torch.equal(d, tsp.spmm_ell_cuda(ids.contiguous(), w.contiguous(), z))
    mag = torch.einsum("nh,nhb->nb", w.abs(), z.abs()[ids.long()])
    assert bool(((d - tsp.spmm_ell_naive_plain(ids, w, z)).abs()
                 <= 1e-5 + 1e-5 * mag).all())
    return d


@pytest.mark.parametrize("h", [1, 3, 13, 48, 64, 65, 160, 300])
@pytest.mark.parametrize("b", [3, 64, 256])
def test_spmm_naive_kernel_bit_equal_to_blocked(cuda, b, h):
    """B6b at one-stage tiles (h <= 128), tiles whose rows cross stages
    (h 160, 300), one and several column chunks: bit-equal to B2; n is not
    a multiple of a tile's rows and every seventh row has no nonzero
    slot."""
    rng = np.random.default_rng(b * 1000 + h)
    n = 5 * tsp.naive_tile_rows(h) + 3
    ids, w, z = (x.to(cuda) for x in _blocked_case(rng, n, h, 900, b))
    d = _naive_vs_blocked(ids, w, z)
    assert not d[::7].any()


@pytest.mark.parametrize("h", [1, 3, 13, 47, 300])
def test_spmm_naive_kernel_misaligned_views(cuda, h):
    """ids[1:] and a w two words into its buffer: blocks that start and end
    off a 16-byte boundary, their heads and tails by ordinary loads."""
    rng = np.random.default_rng(h)
    n = 3 * tsp.naive_tile_rows(h) + 5
    ids, w, z = (x.to(cuda) for x in _blocked_case(rng, n + 1, h, 700, 64))
    buf = torch.zeros(n * h + 3, device=cuda)
    w_view = buf[2:2 + n * h].view(n, h)
    w_view.copy_(w[1:])
    assert ids[1:].data_ptr() % 16 or h % 4 == 0
    _naive_vs_blocked(ids[1:], w_view, z)
    _naive_vs_blocked(ids[1:], w[1:], z)


def test_spmm_naive_kernel_chunk_shape_and_wide_rows(cuda):
    """The vocabulary-chunk call's shape (chunk-relative ids into a Z of
    (512, 64), about one slot in 143 nonzero) and rows of 2,048 slots, each
    two stages of its own."""
    r_ids = torch.tensor(np.random.default_rng(5).integers(
        0, 73_123, size=(20_000, 48)).astype(np.int32), device=cuda)
    r_w = torch.rand(20_000, 48, device=cuda)
    zc = torch.rand(512, 64, device=cuda)
    for lo in (0, 36_352):
        c_ids, c_w = tfs.chunk_relative(r_ids, r_w, lo, 512)
        _naive_vs_blocked(c_ids, c_w, zc)
    rng = np.random.default_rng(6)
    ids, w, z = (x.to(cuda) for x in _blocked_case(rng, 301, 2048, 5000, 64))
    _naive_vs_blocked(ids, w, z)


def test_spmm_naive_kernel_z_past_2_32_entries(cuda):
    """A Z of more than 2^32 floats (17.2 GB): the listed slots keep their
    ids and the Z offsets go 64-bit (the WIDE instance); bit-equal to B2,
    whose offsets are 64-bit always, on ids at both ends of Z."""
    v, b = 2**32 // 64 + 16, 64
    z = torch.zeros((v, b), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    z[-2048:] = torch.randn(2048, b, device=cuda, generator=g)
    z[:2048] = torch.randn(2048, b, device=cuda, generator=g)
    ids = torch.randint(0, 2048, (1000, 48), device=cuda, generator=g,
                        dtype=torch.int32)
    ids[::2] += v - 2048
    w = torch.rand(1000, 48, device=cuda, generator=g)
    w[w < 0.3] = 0.0
    d = tsp.spmm_ell_naive_cuda(ids, w, z)
    assert torch.equal(d, tsp.spmm_ell_cuda(ids, w, z))
    assert bool(d[::2].abs().sum(1).gt(0).all())
    del z


def test_spmm_naive_kernel_refuses_what_it_does_not_take(cuda):
    """What the kernel cannot take raises before a launch, and counts none;
    an empty ELL (h = 0) gives zeros, as the blocked kernel does, with no
    launch."""
    rng = np.random.default_rng(8)
    ids, w, z = (x.to(cuda) for x in _blocked_case(rng, 40, 12, 100, 64))
    _build.reset_launches()
    bad = [
        (ids[:, ::2], w[:, ::2], z),              # not contiguous
        (ids, w.double(), z),                     # w not f32
        (ids.cpu(), w, z),                        # ids on the CPU
        (ids, w[:-1].contiguous(), z),            # w not ids' shape
    ]
    for i, w_, z_ in bad:
        with pytest.raises(ValueError):
            tsp.spmm_ell_naive_cuda(i, w_, z_)
    empty = (ids[:, :0].contiguous(), w[:, :0].contiguous(), z)
    d0 = tsp.spmm_ell_naive_cuda(*empty)
    assert d0.shape == (40, 64) and not d0.any()
    assert torch.equal(d0, tsp.spmm_ell_cuda(*empty))
    assert _build.LAUNCHES["spmm_ell_naive"] == 0
    tsp.spmm_ell_naive_cuda(ids, w, z)
    assert _build.LAUNCHES["spmm_ell_naive"] == 1


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


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_moe_mla_models_on_the_card_match_the_cpu(cuda, arch):
    """The smoke configs of the MoE/MLA models: forward_with_cache, four
    decode steps and (grok) the int8-cache decode on the card against the
    same on the CPU; grok's prefill runs B8 once a layer, deepseek's MLA
    none.  grok's smoke heads are cut to 2 over 1 (dh 32: B8 takes dh 32,
    64 and 128, the smoke config's 4 heads give 16)."""
    import dataclasses

    from repro_torch.configs import get_spec
    from repro_torch.models.transformer import kv_quant as tkv

    cfg = get_spec(arch).smoke_cfg
    if cfg.attention == "gqa":
        cfg = dataclasses.replace(cfg, n_heads=2, n_kv_heads=1, d_head=0)
    cpu_p = TM.init_params(cfg, seed=0, device="cpu")
    gpu_p = {k: ([{a: _to(b, cuda) for a, b in lp.items()} for lp in v]
                 if k == "prefix_layers" else _to(v, cuda))
             for k, v in cpu_p.items()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(3))
    _build.reset_launches()
    got, gc = TM.forward_with_cache(gpu_p, tokens[:, :16].to(cuda), cfg, 24)
    assert _build.LAUNCHES["flash_attention"] == (
        cfg.n_layers if cfg.attention == "gqa" else 0)
    want, wc = TM.forward_with_cache(cpu_p, tokens[:, :16], cfg, 24)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gc.k.cpu(), wc.k, rtol=1e-4, atol=1e-4)
    for i in range(16, 20):
        g, gc = TM.decode_step(gpu_p, gc, tokens[:, i:i + 1].to(cuda), cfg)
        w, wc = TM.decode_step(cpu_p, wc, tokens[:, i:i + 1], cfg)
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    if cfg.attention == "gqa":
        gq = tkv.init_quant_cache(cfg, 2, 8, device=cuda)
        wq = tkv.init_quant_cache(cfg, 2, 8, device="cpu")
        for i in range(6):
            g, gq = TM.decode_step_quant(gpu_p, gq, tokens[:, i:i + 1].to(cuda),
                                         cfg)
            w, wq = TM.decode_step_quant(cpu_p, wq, tokens[:, i:i + 1], cfg)
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# Segmented corpora and the serve step on the card
# ---------------------------------------------------------------------------
def test_fused_topk_kernel_d21_with_tombstones_and_shifted_gids(cuda):
    """B3 with d21 and row_valid together (empty dead rows at the tail, as
    a compacted segment holds its deleted docs) and q_gid shifted by a
    segment offset, with
    values below 0 and past n that must match no row."""
    rng = np.random.default_rng(21)
    n, n_real, b, off = 4096, 4000, 64, 688_000
    ids, w = (x.to(cuda) for x in _ell(rng, n, 48, 900))
    w[n_real:] = 0.0
    ids[n_real:] = 0
    z = torch.tensor(np.abs(rng.normal(size=(900, b))).astype(np.float32)).to(cuda)
    d21 = torch.tensor(np.abs(rng.normal(size=(n, b)) * 8).astype(np.float32)).to(cuda)
    live = torch.tensor(rng.random(n) > 0.2).to(cuda)
    live[n_real:] = False
    gids = np.concatenate([off + rng.integers(0, n_real, b - 8),
                           [0, 5, off - 1, off + n, off + n + 7, 2 ** 30,
                            off + n_real - 1, off]]).astype(np.int32)
    q_gid = torch.tensor(gids).to(cuda) - off
    for k in (20, 32, 256):
        v, i = tfs.phase2_topk_cuda(ids, w, z, k, row_valid=live, q_gid=q_gid,
                                    d21=d21)
        pv, pi = tfs.phase2_topk_plain(ids, w, z, k, row_block=4096,
                                       row_valid=live, q_gid=q_gid, d21=d21)
        _assert_topk_matches_plain(v, i, pv, pi)
        assert bool(live[i.long()].all()) and int(i.max()) < n_real
        assert not bool((i == q_gid[:, None]).any())


def _grown_pair(cuda, seed=5):
    """A segmented engine (base, two deltas, deletions, a copy of doc
    5 last) and its one-segment rebuild, on the card, with their docs."""
    from repro_torch.data.docs import DocSet

    c = make_corpus(CorpusSpec(n_docs=3000, vocab_size=2000, emb_dim=300,
                               h_max=48, mean_h=27.5, n_classes=4, seed=seed),
                    device="cpu")
    docs = c.docs.to(cuda)
    all_docs = DocSet(torch.cat([docs.ids, docs.ids[5:6]]),
                      torch.cat([docs.weights, docs.weights[5:6]]))
    seg = tlc.SegmentedEngine(docs[:2400], c.emb)
    seg.append(docs[2400:2700])
    seg.append(all_docs[2700:])
    dead = list(range(64, 3000, 37)) + [60, 61]
    seg.delete(dead)
    mono = tlc.SegmentedEngine(all_docs, c.emb)
    mono.delete(dead)
    return c, all_docs, seg, mono, dead


def test_segmented_fold_bit_equals_monolithic_rebuild(cuda):
    """B1 + B3 (+ d21) per segment, merged: the same values and ids as one
    segment over the same docs, bit for bit; no dead doc or id past n_docs
    comes back; the copy of doc 5 ties with it, right after."""
    c, docs, seg, mono, dead = _grown_pair(cuda)
    q = docs[:64]
    _build.reset_launches()
    for method, k in (("topk_streaming", 32), ("symmetric_topk_streaming", 20),
                      ("topk", 20)):
        a = getattr(seg, method)(q, k)
        b = getattr(mono, method)(q, k)
        assert torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)
        assert not np.isin(dead, a.indices.cpu().numpy()).any()
        assert int(a.indices.max()) < seg.n_docs and int(a.indices.min()) >= 0
        row = a.indices[5].tolist()
        assert row.index(seg.n_docs - 1) == row.index(5) + 1
    assert _build.LAUNCHES["fused_topk"] == 3 * (3 + 1)
    assert _build.LAUNCHES["rwmd_d21"] == 2 * (3 + 1)
    for method in ("one_sided", "symmetric"):
        assert torch.equal(getattr(seg, method)(q), getattr(mono, method)(q))
    cand = seg.topk_streaming(q, 16).indices
    a = seg.rerank_topk(q, cand, 5, sinkhorn_kw=RERANK_KW)
    b = mono.rerank_topk(q, cand, 5, sinkhorn_kw=RERANK_KW)
    assert torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)


def test_merge_topk_ranks_the_kernels_filler_last(cuda):
    """Segments with fewer live rows than k return B3's (3.4e38, -1) filler;
    the merge ranks it after every live doc and adds no offset to -1."""
    from repro_torch.core.topk import TopK, merge_topk

    d = torch.tensor([[1.0, 3.0, tp1.BIG], [2.0, tp1.BIG, tp1.BIG]],
                     device=cuda)
    i = torch.tensor([[7, 2, -1], [4, -1, -1]], dtype=torch.int32, device=cuda)
    p2 = TopK(torch.tensor([[0.5, tp1.BIG], [tp1.BIG, tp1.BIG]], device=cuda),
              torch.tensor([[40, -1], [-1, -1]], dtype=torch.int32, device=cuda))
    m = merge_topk([TopK(d, i), p2], 4)
    assert m.indices.tolist() == [[40, 7, 2, -1], [4, -1, -1, -1]]
    c, docs, _, _, _ = _grown_pair(cuda)
    seg = tlc.SegmentedEngine(docs[:100], c.emb)
    seg.append(docs[100:110])
    seg.delete(list(range(100, 108)) + list(range(0, 100, 2)))
    for method in ("topk_streaming", "symmetric_topk_streaming"):
        tk = getattr(seg, method)(docs[:4], 60)
        n_live = seg.n_live
        assert n_live == 52
        assert bool((tk.indices[:, :n_live] >= 0).all())
        assert bool((tk.indices[:, n_live:] == -1).all())
        assert bool((tk.dists[:, n_live:] == tp1.BIG).all())
        assert bool(torch.from_numpy(seg.live_mask()).to(cuda)[
            tk.indices[:, :n_live].long()].all())


def test_segmented_serve_step_on_the_card_matches_the_cpu(cuda):
    """Tiers 0-2 and self-exclusion of the segmented step: card against CPU
    (indices exact where the gaps are clear), and one serve call at an
    unchanged version copies nothing to the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    c, docs, seg, _, dead = _grown_pair(cuda)
    cpu = tlc.SegmentedEngine(docs[:2400].to("cpu"), c.emb, device="cpu")
    cpu.append(docs[2400:2700].to("cpu"))
    cpu.append(docs[2700:].to("cpu"))
    cpu.delete(dead)
    atol = 4.0 * float(np.sqrt(2.0 ** -23 * float((cpu.emb_full ** 2).sum(1).max())))
    kw = dict(k=5, bf16_matmul=False, refine=True, rerank_wmd=True,
              rerank_budget=32, wmd_kw=RERANK_KW)
    q = docs[:64]
    for self_exclude in (False, True):
        ids = dict(query_ids=torch.arange(64, device=cuda)) if self_exclude else {}
        g = build_serve_step(engine=seg, self_exclude=self_exclude, **kw)
        h = build_serve_step(engine=cpu, self_exclude=self_exclude, **kw)
        cpu_ids = {k: v.cpu() for k, v in ids.items()}
        # tier 0 is compared on the queries whose 32 candidates agree as sets
        cand = [build_serve_step(engine=e, self_exclude=self_exclude,
                                 **dict(kw, k=32))(x, tier=1, **i).topk.indices
                for e, x, i in ((seg, q, ids), (cpu, q.to("cpu"), cpu_ids))]
        same = torch.tensor([set(x.tolist()) == set(y.tolist())
                             for x, y in zip(cand[0].cpu(), cand[1])])
        assert float(same.float().mean()) >= 0.9
        for tier in (1, 2, 0):
            a = g(q, tier=tier, **ids).topk
            b = h(q.to("cpu"), tier=tier, **cpu_ids).topk
            rows = same if tier == 0 else torch.ones(64, dtype=torch.bool)
            ad, ai = a.dists.cpu()[rows], a.indices.cpu()[rows]
            torch.testing.assert_close(ad, b.dists[rows], rtol=1e-4, atol=atol)
            clear = _gap_clear(b.dists[rows], atol)
            assert torch.equal(ai[clear], b.indices[rows][clear])
            if self_exclude:
                assert not bool((a.indices == ids["query_ids"][:, None]).any())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            g(q, **ids)
            torch.cuda.synchronize()
        copies = [e.key for e in prof.key_averages() if "HtoD" in e.key]
        assert not copies, copies


def _indexed(cuda, **kw):
    """``_grown_pair``'s segmented engine with an 8-cell index over it."""
    from repro_torch.index import ClusterIndex

    c, docs, seg, _, dead = _grown_pair(cuda)
    kw = dict(dict(num_cells=8, top_p=8, probe_cap=8, seed=0), **kw)
    return c, docs, seg, ClusterIndex(seg, **kw), dead


def test_exhaustive_routing_bit_equals_segmented_topk(cuda):
    """Every cell for every query, bound off: the routed top-k and the
    routed serve step (tiers 0-2, self-excluding) equal the flat segmented
    scan and step bit for bit, on B1, B3 and the d21 mode per cell."""
    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    c, docs, seg, idx, dead = _indexed(cuda)
    q = docs[:64]
    _build.reset_launches()
    a = idx.routed_topk(q, 20, top_p=8, bound_slack=None)
    n_cells = sum(cell is not None for cell in idx.cells)
    assert _build.LAUNCHES["rwmd_d21"] == n_cells
    assert _build.LAUNCHES["fused_topk"] == n_cells
    b = seg.topk(q, 20)
    assert torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)
    assert not np.isin(dead, a.indices.cpu().numpy()).any()
    kw = dict(k=5, bf16_matmul=False, refine=True, rerank_wmd=True,
              rerank_budget=32, wmd_kw=RERANK_KW)
    ids = torch.arange(64, device=cuda)
    for self_exclude, args in ((False, (q,)), (True, (q, ids))):
        flat = build_serve_step(engine=seg, self_exclude=self_exclude, **kw)
        routed = build_serve_step(engine=seg, index=idx,
                                  self_exclude=self_exclude, **kw)
        for tier in (0, 1, 2):
            x, y = routed(*args, tier=tier), flat(*args, tier=tier)
            assert torch.equal(x.topk.dists, y.topk.dists)
            assert torch.equal(x.topk.indices, y.topk.indices)
            if tier == 0:
                assert torch.equal(x.pruned_exact, y.pruned_exact)


@pytest.mark.parametrize("symmetric", [False, True])
def test_cell_on_a_query_subset_bit_equals_the_cell_on_all(cuda, symmetric):
    """B1, B3 (and the d21 mode) on a cell's routed queries only give the
    rows they give with every query in the batch, bit for bit."""
    c, docs, seg, idx, _ = _indexed(cuda)
    q = docs[:64]
    every = np.ones((64, 1), bool)
    some = np.zeros((64, 1), bool)
    some[[0, 3, 17, 40, 41, 63]] = True
    rows = torch.tensor([0, 3, 17, 40, 41, 63], device=cuda)
    for j, cell in enumerate(idx.cells):
        if cell is None:
            continue
        cells = np.full((64, 1), j, dtype=np.int32)
        a = idx.fold_cells(q, 20, [j], cells, every, symmetric=symmetric)
        b = idx.fold_cells(q, 20, [j], cells, some, symmetric=symmetric)
        assert torch.equal(a.dists[rows], b.dists[rows])
        assert torch.equal(a.indices[rows], b.indices[rows])


def test_routed_step_maps_query_ids_to_cell_rows(cuda):
    """Self-exclusion per cell: a member query excludes its own row, a
    query id that is not the query's doc excludes that doc only, and a
    deleted self stays out through the live mask."""
    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    c, docs, seg, idx, dead = _indexed(cuda)
    q = docs[:64]
    ids = torch.arange(64, device=cuda)
    foreign = ids.clone()
    foreign[0] = 2999               # query 0 excludes doc 2999 instead
    kw = dict(k=20, bf16_matmul=False, self_exclude=True)
    routed = build_serve_step(engine=seg, index=idx, **kw)
    flat = build_serve_step(engine=seg, **kw)
    for qid in (ids, foreign):
        a, b = routed(q, qid, tier=1).topk, flat(q, qid, tier=1).topk
        assert torch.equal(a.dists, b.dists) and torch.equal(a.indices, b.indices)
        assert not bool((a.indices == qid[:, None]).any())
        assert not np.isin(dead, a.indices.cpu().numpy()).any()   # 60, 61
    assert int(routed(q, foreign, tier=1).topk.indices[0, 0]) == 0


# ---------------------------------------------------------------------------
# The serving plane on the card
# ---------------------------------------------------------------------------
def _serving_corpus(cuda, n=3000):
    c = make_corpus(CorpusSpec(n_docs=n, vocab_size=2000, emb_dim=300,
                               h_max=48, mean_h=27.5, n_classes=4, seed=8),
                    device="cpu")
    ids, w = c.docs.ids.numpy(), c.docs.weights.numpy()
    return c, [(ids[i], w[i]) for i in range(64)]


def _serving_cfg(**kw):
    from repro_torch.serving import ServerConfig

    base = dict(k=16, max_batch=64, h_max=48, refine_symmetric=True,
                rerank_wmd=True, wmd_kw=RERANK_KW, max_wait_s=5.0)
    base.update(kw)
    return ServerConfig(**base)


def test_unrouted_serve_dispatch_issues_no_sync(cuda):
    """Tiers 0, 1 and 2 of the unrouted dispatch (the query copy, the serve
    step, the result copies and the event) make no synchronizing call."""
    from repro_torch.serving import QueryServer

    c, qs = _serving_corpus(cuda)
    server = QueryServer(c.docs, c.emb, _serving_cfg())
    core = server._core
    for tier in (0, 1, 2):                      # warm-up: builds, caches
        core.collect(core.dispatch(qs))
        server._serve(core.pad_batch(qs), tier=tier)
    torch.cuda.synchronize()
    for tier in (0, 1, 2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            inflight = core._raw_serve(qs, tier, None)
            host, event = core._readback(inflight)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert event is not None
        event.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = core.dispatch(qs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(a[0][0] == j for j, a in enumerate(core.collect(h)))


def test_inflight_event_not_ready_then_ready(cuda):
    """A batch queued behind a long kernel reports not-ready, then ready;
    collect returns the sync server's answers."""
    from repro_torch.serving import AsyncQueryServer, QueryServer

    c, qs = _serving_corpus(cuda)
    sync = QueryServer(c.docs, c.emb, _serving_cfg())
    for q in qs:
        sync.submit(*q)
    want = sync.flush()
    server = AsyncQueryServer(c.docs, c.emb, _serving_cfg())
    try:
        core = server._core
        core.collect(core.dispatch(qs))             # warm-up
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)            # ~1 s of spinning
        h = core.dispatch(qs)
        # Held so that the idle worker, which collects the oldest batch in
        # flight on its next look, leaves the planted one alone.
        with server._lock:
            server._inflight.append((h, [], []))
            assert not server._oldest_ready()
            torch.cuda.synchronize()
            assert server._oldest_ready() and h.event.query()
            server._inflight.clear()
        got = core.collect(h)
    finally:
        server.close()
    for g, w in zip(got, want):
        assert g[0].tobytes() == w[0].tobytes()
        assert g[1].tobytes() == w[1].tobytes()


def test_evict_and_readmit_bit_equal_on_the_card(cuda):
    """An evicted corpus leaves the card; readmitted, it answers as before,
    bit for bit."""
    from repro_torch.data.docs import DocSet
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.serving import CorpusManager

    c, _ = _serving_corpus(cuda)
    mgr = CorpusManager(c.emb)
    mgr.add_corpus("a", c.docs[:2000])
    mgr.add_corpus("b", c.docs[2000:])
    st = mgr.checkout("a")
    st.engine.delete([7, 300])
    q = DocSet(c.docs.ids[:64], c.docs.weights[:64]).to(cuda)
    kw = dict(k=16, refine=True, rerank_wmd=True, rerank_budget=32,
              wmd_kw=RERANK_KW, bf16_matmul=False)
    before = build_serve_step(engine=st.engine, **kw)(q).topk
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    mgr.evict("a")
    del st
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() < held
    st = mgr.checkout("a")
    after = build_serve_step(engine=st.engine, **kw)(q).topk
    assert torch.equal(before.indices, after.indices)
    assert torch.equal(before.dists, after.dists)
    assert not bool((after.indices == 7).any())


def test_sentinel_sees_no_load_after_warmup(cuda):
    """Armed after warm-up, the sentinel sees no kernel-library load
    across an adaptive-budget rebuild and a tier switch."""
    from repro_torch.obs import sentinel
    from repro_torch.serving import FaultPlan, QueryServer

    c, qs = _serving_corpus(cuda)
    server = QueryServer(c.docs, c.emb, _serving_cfg(
        adaptive_budget=True, degradation=True, fail_streak_down=1,
        k=8), faults=FaultPlan(nan_batches={2: "all"}))
    core = server._core
    for tier in (0, 1, 2):
        server._serve(core.pad_batch(qs), tier=tier)
    server._build_serve(64)(core.pad_batch(qs))
    torch.cuda.synchronize()
    sentinel.reset()
    sentinel.arm()
    try:
        for _ in range(4):
            for q in qs:
                server.submit(*q)
            server.flush()
        snap = server.stats_snapshot()
        sentinel.check()
        assert sentinel.snapshot()["loads"] == {}
    finally:
        sentinel.reset()
    assert snap["budget_rebuilds"] >= 1 and snap["tier_counts"][1] >= 1


@pytest.mark.parametrize("k", [300, 100])
@pytest.mark.parametrize("bad", ["nan", "inf"])
def test_nonfinite_z_row_through_a_positive_weight(cuda, bad, k):
    """A Z row holding NaN or inf, reached through a positive weight: B2's
    D row for that doc is non-finite, as its plain version's is.  A
    zero-weight slot on that row adds nothing in the kernel, where the
    plain version (and the reference) adds 0 * Z[id] and turns the row
    NaN.  B3 equals its plain fold in every slot: k = 300 covers every doc
    (the global carry, the non-finite docs last, by id, at their value), k
    = 100 the shared-memory carry; also with a d21 operand holding NaN and
    inf, and with tombstones and self-exclusion, whose unfilled slots are
    (3.4e38, -1) from the kernel and (+inf, -1) from the plain fold."""
    rng = np.random.default_rng(3)
    n, h, v, b = 300, 48, 700, 64
    ids, w = _ell(rng, n, h, v)
    ids = torch.where((ids == 5) & (w == 0), 6, ids)   # no stray zero slots
    z = torch.rand(v, b, generator=torch.Generator().manual_seed(4))
    ids, w, z = ids.to(cuda), w.to(cuda), z.to(cuda)
    z[5] = float(bad)
    ids[10, 3], w[10, 3] = 5, 0.25                # doc 10: positive weight
    hit = ((ids == 5) & (w > 0)).any(dim=1)
    assert bool(hit[10]) and 1 < int(hit.sum()) < n // 4
    zero = ids.clone()
    slot = int(torch.nonzero(w[20] == 0)[0, 0])
    zero[20, slot] = 5                            # doc 20: a zero-weight slot
    assert not bool(hit[20])
    got = tsp.spmm_ell_cuda(zero, w, z)
    want = tsp.spmm_ell_plain(zero, w, z)
    assert bool((~torch.isfinite(got[hit])).all())
    assert bool((~torch.isfinite(want[hit])).all())
    assert bool(torch.isfinite(got[~hit]).all())
    assert not bool(torch.isfinite(want[20]).any())
    rest = ~hit
    rest[20] = False
    torch.testing.assert_close(got[rest], want[rest], rtol=1e-5, atol=1e-5)
    d21 = torch.rand(n, b, generator=torch.Generator().manual_seed(5))
    d21[::13, 3], d21[4::17, 7] = float("nan"), float("inf")
    masks = dict(row_valid=torch.arange(n) % 9 != 4,
                 q_gid=torch.arange(b, dtype=torch.int32) * 4)
    for extra in ({}, dict(d21=d21), dict(d21=d21, **masks)):
        extra = {key: x.to(cuda) for key, x in extra.items()}
        kd, ki = tfs.phase2_topk_cuda(ids, w, z, k, **extra)
        pd, pi = tfs.phase2_topk_plain(ids, w, z, k, **extra)
        real = pi >= 0
        assert torch.equal(ki, pi)
        # the kernel's sums and the plain version's differ in order only
        torch.testing.assert_close(kd[real], pd[real], rtol=1e-5, atol=1e-5,
                                   equal_nan=True)
        assert bool((kd[~real] == 3.4e38).all())
        assert bool(torch.isinf(pd[~real]).all())
        if not extra and k == n:
            fin = n - int(hit.sum())
            assert torch.equal(ki[:, fin:], torch.nonzero(hit)[:, 0].to(
                torch.int32).expand(b, -1))


def test_workload_primitives_and_scheduler_match_the_cpu(cuda):
    """``phase1_resident`` (B1) and ``one_sided_rows`` (B2) of a monolithic
    and a segmented engine on the card against the same calls on the CPU
    (the gram form's noise: 4 x sqrt(eps * max |e|^2) absolute, as the
    serve-step test holds it); then ``corpus_self_topk`` on the card: B1
    once a tile and B2 twice a visited block, the CPU's ids where the gaps
    are clear, the segmented engine bit for bit equal to the monolithic one
    before deletions, and no deleted doc after them."""
    from repro_torch.workloads import corpus_self_topk

    c, docs, seg, _, dead = _grown_pair(cuda)
    docs = docs[:600]
    mono = tlc.LCRWMDEngine(docs, c.emb)
    cpu = tlc.LCRWMDEngine(docs.to("cpu"), c.emb, device="cpu")
    atol = 4.0 * float(np.sqrt(2.0 ** -23 * float((cpu.emb_full ** 2).sum(1).max())))
    idx = torch.tensor([0, 5, 77, 599, -1, 600], device=cuda)
    rows = torch.tensor([1, 5, 300, 599, 600], device=cuda)
    z = mono.phase1_resident(idx)
    zc = cpu.phase1_resident(idx.cpu())
    torch.testing.assert_close(z[:, :4].cpu(), zc[:, :4], rtol=1e-4, atol=atol)
    torch.testing.assert_close(mono.one_sided_rows(rows, z)[:, :4].cpu(),
                               cpu.one_sided_rows(rows.cpu(), zc)[:, :4],
                               rtol=1e-4, atol=atol)
    s2 = tlc.SegmentedEngine(docs[:450], c.emb)
    s2.append(docs[450:])
    zs = s2.phase1_resident(idx)
    assert len(zs) == 2
    assert torch.equal(s2.one_sided_rows(rows, zs), mono.one_sided_rows(rows, z))
    _build.reset_launches()
    got = corpus_self_topk(mono, 8, tile=128)
    assert _build.LAUNCHES["lc_rwmd_phase1"] == 5
    assert _build.LAUNCHES["spmm_ell"] == 2 * 15
    want = corpus_self_topk(cpu, 8, tile=128)
    torch.testing.assert_close(got.dists.cpu(), want.dists, rtol=1e-4,
                               atol=atol)
    clear = _gap_clear(want.dists, atol)
    assert torch.equal(got.indices.cpu()[clear], want.indices[clear])
    sg = corpus_self_topk(s2, 8, tile=128)
    assert torch.equal(sg.indices, got.indices) and torch.equal(sg.dists, got.dists)
    s2.delete([3, 470])
    sg = corpus_self_topk(s2, 8, tile=128)
    assert bool((sg.indices[[3, 470]] == -1).all())
    assert not bool(torch.isin(sg.indices, torch.tensor(
        [3, 470], dtype=torch.int32, device=cuda)).any())


def _mesh_pair(cuda):
    c = make_corpus(CorpusSpec(n_docs=6000, vocab_size=4000, emb_dim=64,
                               h_max=32, mean_h=18.0, seed=11), device=cuda)
    return c, tlc.LCRWMDEngine(c.docs, c.emb)


@pytest.mark.parametrize("shards", [2, 8])
def test_mesh_vocab_shard_partials_sum_to_one_sided(cuda, shards):
    """Each model rank of a (1, shards) mesh, run alone in turn: its B1 on
    its vocabulary rows and its B2 partial (ids outside its span at weight
    0) sum in rank order to ``one_sided`` within B2's tolerance."""
    from torch_mesh_ranks import RankAlone

    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    c, eng = _mesh_pair(cuda)
    q = c.docs[:64]
    _build.reset_launches()
    want = eng.one_sided(q)
    b1 = _build.LAUNCHES["lc_rwmd_phase1"]
    _build.reset_launches()
    total = 0
    for rank in range(shards):
        step = build_serve_step(RankAlone(shards, rank, cuda), engine=eng,
                                k=8, streaming=False, bf16_matmul=False)
        total = total + step(q).d_local
    assert _build.LAUNCHES["lc_rwmd_phase1"] == shards * b1
    assert _build.LAUNCHES["spmm_ell"] == shards
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


def test_mesh_of_one_step_is_the_meshless_step_on_the_card(cuda):
    """On a mesh of one rank (no process group), the monolithic step
    (streaming and materialized, self-excluding), the engine-less step and
    the all-pairs D1 equal the mesh-less ones bit for bit."""
    from repro_torch.distributed.lcrwmd_dist import (build_allpairs_d1,
                                                     build_serve_step)
    from repro_torch.launch.mesh import make_host_mesh

    c, eng = _mesh_pair(cuda)
    mesh = make_host_mesh()
    assert mesh.device.type == "cuda" and mesh.size == 1
    q, ids = c.docs[:64], torch.arange(64, device=cuda)
    for streaming in (True, False):
        kw = dict(k=32, engine=eng, self_exclude=True, streaming=streaming)
        a = build_serve_step(mesh, **kw)(q, ids)
        b = build_serve_step(**kw)(q, ids)
        assert torch.equal(a.topk.dists, b.topk.dists)
        assert torch.equal(a.topk.indices, b.topk.indices)
        assert streaming or torch.equal(a.d_local, b.d_local)
    a = build_serve_step(mesh, k=32)(c.docs, q, c.emb)
    b = build_serve_step(k=32)(c.docs, q, c.emb)
    assert torch.equal(a.topk.indices, b.topk.indices)
    assert torch.equal(a.d_local, b.d_local)
    assert torch.equal(build_allpairs_d1(mesh)(c.docs, q, c.emb),
                       build_allpairs_d1()(c.docs, q, c.emb))


def _mesh_segmented(cuda):
    """A 6,000-doc corpus as two segments with 60 tombstones (query 3's
    own doc among them), and a 16-cell index over them."""
    from repro_torch.index import ClusterIndex

    c, _ = _mesh_pair(cuda)
    seg = tlc.SegmentedEngine(c.docs[:4000], c.emb)
    seg.append(c.docs[4000:])
    idx = ClusterIndex(seg, num_cells=16, top_p=4, seed=0)
    seg.delete(np.r_[3, np.arange(100, 6000, 100)])
    return c, seg, idx


def test_mesh_segment_shards_combine_to_the_segmented_step(cuda):
    """Each rank of a (1, 2) and a (2, 1) mesh over two segments with
    tombstones, run alone in turn.  (1, 2): each rank's B1 on its
    vocabulary rows of each segment and its B2 partial sum in rank order
    to ``one_sided`` (live rows) within B2's tolerance.  (2, 1): each
    rank's self-excluding candidates (B1 + B3 on its row blocks) merge to
    the one-device segmented step's bit for bit."""
    from torch_mesh_ranks import RankAlone

    from repro_torch.core.topk import merge_topk
    from repro_torch.distributed import lcrwmd_dist as td

    c, seg, _ = _mesh_segmented(cuda)
    q, ids = c.docs[:64], torch.arange(64, device=cuda)
    live = seg.live_mask_device()
    want = seg.one_sided(q)
    t_q = seg._gather_flat(q.ids)
    total = None
    _build.reset_launches()
    for rank in range(2):
        mesh = RankAlone(2, rank, cuda)
        parts = []
        for s in seg.segments:
            sh = td._shard(mesh, s.tensors, False)
            z = td._shard_z(mesh, sh, t_q, q.weights, bf16_matmul=False,
                            full_mesh=False)
            parts.append(td._spmm(sh.ids, sh.w, z))
        d = torch.cat(parts)
        total = d if total is None else total + d
    assert _build.LAUNCHES["spmm_ell"] == 2 * seg.n_segments
    torch.testing.assert_close(total[live], want[live], rtol=1e-5, atol=1e-5)
    kw = dict(k=32, engine=seg, self_exclude=True, bf16_matmul=False)
    one = td.build_serve_step(**kw)(q, ids, tier=1).topk
    _build.reset_launches()
    # the rank alone gathers no Z slices: its phase 1 covers the vocabulary
    halves = [td.build_serve_step(RankAlone(1, rank, cuda, data=2),
                                  phase1_full_mesh=False, **kw)(
        q, ids, tier=1).topk for rank in range(2)]
    assert _build.LAUNCHES["fused_topk"] == 2 * seg.n_segments
    got = merge_topk(halves, 32)
    assert torch.equal(got.dists, one.dists)
    assert torch.equal(got.indices, one.indices)


def test_mesh_of_one_segmented_and_routed_steps_on_the_card(cuda):
    """On a mesh of one rank (no process group) the segmented and routed
    steps run the mesh program: at tiers 0 (refine and rerank) and 1,
    self-excluding, bit for bit the mesh-less steps, across a delete and
    a compact."""
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.launch.mesh import make_host_mesh

    c, seg, idx = _mesh_segmented(cuda)
    mesh = make_host_mesh()
    q, ids = c.docs[:64], torch.arange(64, device=cuda)
    kw = dict(k=16, engine=seg, self_exclude=True, refine=True,
              rerank_wmd=True, rerank_budget=32,
              wmd_kw=dict(eps=0.05, eps_scaling=2, max_iters=100))
    for extra in ({}, dict(index=idx)):
        a, b = build_serve_step(mesh, **kw, **extra), build_serve_step(
            **kw, **extra)
        for change in (None, "delete", "compact"):
            if change == "delete":
                seg.delete([5, 4321])
            elif change == "compact" and not extra:
                seg.compact()
            for tier in (0, 1):
                x, y = a(q, ids, tier=tier), b(q, ids, tier=tier)
                assert torch.equal(x.topk.dists, y.topk.dists)
                assert torch.equal(x.topk.indices, y.topk.indices)
                assert not bool((x.topk.indices == ids[:, None]).any())


def test_mesh_of_one_async_server_on_the_card(cuda):
    """On a mesh of one rank (no process group) the async server, fed raw
    payloads that its worker vectorizes, with an ingest and a delete
    between two parts, answers as the mesh-less async server bit for bit
    (tier 0: refine and rerank), B1, B3 and B4 launched."""
    from _ingest_vectorizers import SeededHistogramVectorizer

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.query_server import AsyncQueryServer, ServerConfig

    c, _ = _mesh_pair(cuda)
    vec = SeededHistogramVectorizer(vocab=4000, h_max=32)
    cfg = ServerConfig(k=16, max_batch=64, h_max=32, rerank_wmd=True,
                       wmd_kw=dict(eps=0.05, eps_scaling=2, max_iters=100))

    def serve(mesh):
        with AsyncQueryServer(c.docs[:5000], c.emb, cfg, mesh=mesh,
                              preprocess=vec) as srv:
            first = [srv.submit(j) for j in range(128)]
            srv.drain()
            srv.ingest(c.docs[5000:])
            srv.delete_docs([1, 5001])
            rest = [srv.submit(j) for j in range(128)]
            srv.drain()
        return [f.result(timeout=300) for f in first + rest]

    _build.reset_launches()
    got = serve(make_host_mesh())
    for name in ("lc_rwmd_phase1", "fused_topk", "sinkhorn_wmd"):
        assert _build.LAUNCHES[name] >= 1, name
    want = serve(None)
    for a, b in zip(got, want):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a.tier == b.tier == 0
    assert not np.isin(np.stack([a[0] for a in got[128:]]), [1, 5001]).any()


def test_mesh_cell_on_the_card_is_the_meshless_step(cuda):
    """``serve_set2_2p8m`` cut to 20,000 of its rows (its h, B and
    vocabulary; inputs drawn on the card): the cell's step on a 1x1 mesh
    equals the mesh-less engine-less step bit for bit under
    ``bf16_matmul``, B1 and B2 launched, and each query finds its row."""
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.launch.cells import build_cell, make_args
    from repro_torch.launch.mesh import make_host_mesh

    cell = build_cell("lcrwmd", "serve_set2_2p8m", make_host_mesh())
    args = make_args(cell, seed=0, device=cuda, rows=20_000)
    _build.reset_launches()
    got = cell.step_fn(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["lc_rwmd_phase1"] >= 1
    assert _build.LAUNCHES["spmm_ell"] >= 1
    want = build_serve_step(k=16, bf16_matmul=True)(*args)
    assert torch.equal(got.topk.dists, want.topk.dists)
    assert torch.equal(got.topk.indices, want.topk.indices)
    assert torch.equal(got.d_local, want.d_local)
    b = args[1].n_docs
    assert bool((got.topk.indices
                 == torch.arange(b, device=cuda)[:, None]).any(1).all())
