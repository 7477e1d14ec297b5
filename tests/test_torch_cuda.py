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
from repro_torch.kernels import fused_stream as tfs
from repro_torch.kernels import lc_rwmd_phase1 as tp1
from repro_torch.kernels import sinkhorn_wmd as tsk
from repro_torch.kernels import spmm_ell as tsp

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


def test_phase1_kernel_matches_plain(cuda):
    g = torch.Generator().manual_seed(0)
    emb = torch.randn(700, 300, generator=g).to(cuda)
    t = torch.randn(5, 37, 300, generator=g).to(cuda)
    valid = (torch.rand(5, 37, generator=g) > 0.3).float().to(cuda)
    for bf16 in (False, True):
        got = tp1.phase1_sq_cuda(emb, t, valid, bf16_matmul=bf16)
        want = tp1.phase1_sq_plain(emb, t, valid, bf16_matmul=bf16)
        # squared space: the gram form's error scales with the norms
        scale = (emb * emb).sum(1)[:, None] + (t * t).sum(2).amax(1)[None, :]
        assert bool(((got - want).abs() <= 1e-5 * scale).all())


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
    v, i = tfs.phase2_topk_cuda(ids, w, z, 16, n_real=777)
    pv, pi = tfs.phase2_topk_plain(ids, w, z, 16, n_real=777)
    assert torch.equal(i, pi) and int(i.max()) < 777
    with pytest.raises(ValueError, match="maximum"):
        tfs.phase2_topk_cuda(ids, w, z, 129)


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
