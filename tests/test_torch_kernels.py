"""The port's kernels against the reference's Pallas kernels.

On the CPU each port wrapper runs its kernel's plain PyTorch version (the
tensors lie on the CPU); the reference's Pallas kernels run in interpret
mode.  The same numpy inputs, made from a seed, go through both.  The
CUDA kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jdist
from repro.core import topk as jtopk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sinkhorn_wmd as jsk
from repro_torch.core import distances as tdist
from repro_torch.core import topk as ttopk
from repro_torch.kernels import _build
from repro_torch.kernels import fused_stream as tfs
from repro_torch.kernels import lc_rwmd_phase1 as tp1
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sinkhorn_wmd as tsk
from repro_torch.kernels import spmm_ell as tsp


def _t(x):
    return torch.tensor(np.asarray(x))


def _mk_queries(rng, b, h, v):
    ids = rng.integers(0, v, size=(b, h)).astype(np.int32)
    w = rng.uniform(0.1, 1.0, size=(b, h)).astype(np.float32)
    for j in range(b):  # random padding tail per query (>= 1 valid word)
        w[j, rng.integers(1, h + 1):] = 0.0
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
    return ids, w


def _mk_ell(rng, n, h, v, pad=0.3):
    ids = rng.integers(0, v, size=(n, h)).astype(np.int32)
    w = rng.uniform(0, 1, size=(n, h)).astype(np.float32)
    w[rng.random(size=w.shape) < pad] = 0.0
    return ids, w


# ---------------------------------------------------------------------------
# B1 phase 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,m,b,h", [
    (512, 48, 4, 16),
    (1024, 300, 2, 32),   # the paper's m=300
    (256, 64, 8, 8),
])
def test_phase1_plain_matches_pallas(v, m, b, h):
    rng = np.random.default_rng(v * 7 + m + b + h)
    emb = rng.normal(size=(v, m)).astype(np.float32)
    q_ids, q_w = _mk_queries(rng, b, h, v)
    want = np.asarray(jops.lc_rwmd_phase1(
        jnp.asarray(emb), jnp.asarray(q_ids), jnp.asarray(q_w), block_v=128,
        interpret=True))
    got = tops.lc_rwmd_phase1(_t(emb), _t(q_ids), _t(q_w)).numpy()
    # atol floor: sqrt(eps·|e|²) gram-expansion noise on near-zero distances
    # (self-match words), as the reference's own kernel test states.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.5e-2)
    oracle = tref.lc_rwmd_phase1_ref(_t(emb), _t(q_ids), _t(q_w)).numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=2.5e-2)


def test_phase1_plain_bf16_matches_pallas():
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(384, 96)).astype(np.float32)
    q_ids, q_w = _mk_queries(rng, 4, 16, 384)
    want = np.asarray(jops.lc_rwmd_phase1(
        jnp.asarray(emb), jnp.asarray(q_ids), jnp.asarray(q_w), block_v=128,
        bf16_matmul=True, interpret=True))
    got = tops.lc_rwmd_phase1(_t(emb), _t(q_ids), _t(q_w),
                              bf16_matmul=True).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=0.7)


def test_phase1_pregathered_matches_pallas():
    rng = np.random.default_rng(12)
    emb = rng.normal(size=(300, 40)).astype(np.float32)
    q_ids, q_w = _mk_queries(rng, 3, 10, 300)
    t = emb[q_ids.reshape(-1)].reshape(3, 10, 40)
    valid = (q_w > 0).astype(np.float32)
    want = np.asarray(jops.lc_rwmd_phase1_pregathered(
        jnp.asarray(emb), jnp.asarray(t), jnp.asarray(valid), block_v=128,
        interpret=True))
    got = tops.lc_rwmd_phase1_pregathered(_t(emb), _t(t), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.5e-2)


def test_phase1_squared_plain_masks_invalid_words():
    rng = np.random.default_rng(13)
    emb = _t(rng.normal(size=(20, 8)).astype(np.float32))
    t = _t(rng.normal(size=(2, 5, 8)).astype(np.float32))
    valid = torch.zeros(2, 5)
    valid[0, 2] = 1.0
    z = tp1.phase1_sq_plain(emb, t, valid)
    assert torch.all(z[:, 1] == np.float32(tp1.BIG))
    want = ((emb - t[0, 2]) ** 2).sum(1)
    assert torch.allclose(z[:, 0], want, rtol=1e-4, atol=1e-4)


def test_phase1_oracle_matches_reference_oracle():
    rng = np.random.default_rng(14)
    emb = rng.normal(size=(128, 24)).astype(np.float32)
    q_ids, q_w = _mk_queries(rng, 3, 6, 128)
    want = np.asarray(jref.lc_rwmd_phase1_ref(
        jnp.asarray(emb), jnp.asarray(q_ids), jnp.asarray(q_w)))
    got = tref.lc_rwmd_phase1_ref(_t(emb), _t(q_ids), _t(q_w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.5e-2)


# ---------------------------------------------------------------------------
# B2 ELL SpMM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,h,v,b", [
    (16, 8, 512, 4),
    (64, 16, 256, 1),
    (8, 32, 1024, 12),
    (13, 8, 256, 3),
])
def test_spmm_plain_matches_pallas(n, h, v, b):
    rng = np.random.default_rng(n * 31 + h + v + b)
    ids, w = _mk_ell(rng, n, h, v)
    z = rng.normal(size=(v, b)).astype(np.float32)
    want = np.asarray(jops.spmm_ell(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(z), mode="blocked",
                                    interpret=True))
    got = tops.spmm_ell(_t(ids), _t(w), _t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = np.asarray(jref.spmm_ell_ref(jnp.asarray(ids), jnp.asarray(w),
                                          jnp.asarray(z)))
    np.testing.assert_allclose(tref.spmm_ell_ref(_t(ids), _t(w), _t(z)).numpy(),
                               oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "naive", "bogus"])
def test_spmm_unported_modes_raise(mode):
    z = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="not ported"):
        tops.spmm_ell(torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 3), z,
                      mode=mode)


# ---------------------------------------------------------------------------
# B3 phase 2 → streaming top-k
# ---------------------------------------------------------------------------
def _fused_inputs(seed, n=40, h1=8, v=96, b=5, h=6, m=16):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(v, m)).astype(np.float32)
    q_ids, q_w = _mk_queries(rng, b, h, v)
    r_ids, r_w = _mk_ell(rng, n, h1, v, pad=0.25)
    r_w[:, 0] = np.maximum(r_w[:, 0], 0.1)  # no empty resident docs
    return emb, q_ids, q_w, r_ids, r_w


@pytest.mark.parametrize("k", [1, 7, 40])
def test_fused_topk_plain_matches_pallas_kernel(k):
    emb, q_ids, q_w, r_ids, r_w = _fused_inputs(21 + k)
    jv, ji = jops.lc_rwmd_fused_topk(
        *map(jnp.asarray, (emb, q_ids, q_w, r_ids, r_w)), k=k, fuse="kernel",
        interpret=True)
    tv, ti = tops.lc_rwmd_fused_topk(
        *map(_t, (emb, q_ids, q_w, r_ids, r_w)), k=k, fuse="kernel")
    # Z feeds these sums: phase 1's gram-noise floor applies (see above).
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=2.5e-2)
    # Random embeddings and random resident docs: no ties, ids exact.
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


def test_fused_topk_jnp_fold_matches_reference():
    emb, q_ids, q_w, r_ids, r_w = _fused_inputs(5)
    jv, ji = jops.lc_rwmd_fused_topk(
        *map(jnp.asarray, (emb, q_ids, q_w, r_ids, r_w)), k=9, fuse="jnp",
        row_block=16)
    tv, ti = tops.lc_rwmd_fused_topk(
        *map(_t, (emb, q_ids, q_w, r_ids, r_w)), k=9, fuse="jnp", row_block=16,
        vocab_chunk=32)
    # Z feeds these sums: phase 1's gram-noise floor applies (see above).
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=2.5e-2)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(ValueError):
        tops.lc_rwmd_fused_topk(*map(_t, (emb, q_ids, q_w, r_ids, r_w)), k=3,
                                fuse="scan")


def test_fused_topk_tie_order_is_value_then_doc_id():
    """Duplicate resident docs tie exactly; both order them by doc id."""
    emb, q_ids, q_w, r_ids, r_w = _fused_inputs(8, n=6)
    r_ids = np.tile(r_ids, (5, 1))[[3 * i % 30 for i in range(30)]]
    r_w = np.tile(r_w, (5, 1))[[3 * i % 30 for i in range(30)]]
    jv, ji = jops.lc_rwmd_fused_topk(
        *map(jnp.asarray, (emb, q_ids, q_w, r_ids, r_w)), k=12, fuse="kernel",
        interpret=True)
    tv, ti = tops.lc_rwmd_fused_topk(
        *map(_t, (emb, q_ids, q_w, r_ids, r_w)), k=12, fuse="kernel")
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    tv, ti = tv.numpy(), ti.numpy()
    same = tv[:, 1:] == tv[:, :-1]
    assert same.any()  # the input really has ties
    assert np.all(ti[:, 1:][same] > ti[:, :-1][same])


def test_streaming_phase2_matches_reference_fold():
    rng = np.random.default_rng(9)
    r_ids, r_w = _mk_ell(rng, 50, 6, 70)
    z = np.abs(rng.normal(size=(70, 4))).astype(np.float32)
    jd, ji = jops.streaming_phase2_topk(jnp.asarray(r_ids), jnp.asarray(r_w),
                                        jnp.asarray(z), 11, row_block=8)
    td, ti = tops.streaming_phase2_topk(_t(r_ids), _t(r_w), _t(z), 11,
                                        row_block=8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def test_phase2_topk_plain_drops_rows_past_n_real():
    rng = np.random.default_rng(10)
    r_ids, r_w = _mk_ell(rng, 20, 4, 30)
    z = _t(rng.normal(size=(30, 3)).astype(np.float32))
    d, i = tfs.phase2_topk_plain(_t(r_ids), _t(r_w), z, 5, n_real=12)
    d2, i2 = tfs.phase2_topk_plain(_t(r_ids[:12]), _t(r_w[:12]), z, 5)
    assert torch.equal(i, i2) and torch.equal(d, d2)
    assert int(i.max()) < 12


# ---------------------------------------------------------------------------
# B4 Sinkhorn-WMD
# ---------------------------------------------------------------------------
CONFIGS = [
    dict(eps=0.01, eps_scaling=4, max_iters=500, tol=1e-5),
    dict(eps=0.02, eps_scaling=3, max_iters=200),
    dict(eps=0.05, eps_scaling=2, max_iters=60),
]


def _random_problems(rng, p=10, h1=12, h2=10, m=16):
    def hist(h):
        w = rng.random(h).astype(np.float32)
        w[rng.random(h) < 0.3] = 0
        if w.sum() == 0:
            w[0] = 1.0
        return w / w.sum()

    w1 = np.stack([hist(h1) for _ in range(p)])
    w2 = np.stack([hist(h2) for _ in range(p)])
    t1 = rng.normal(size=(p, h1, m)).astype(np.float32)
    t2 = rng.normal(size=(p, h2, m)).astype(np.float32)
    return w1, w2, t1, t2


@pytest.mark.parametrize("kw", CONFIGS)
def test_sinkhorn_plain_matches_pallas(kw):
    w1, w2, t1, t2 = _random_problems(np.random.default_rng(0))
    want = np.asarray(jops.sinkhorn_wmd(
        jnp.asarray(t1), jnp.asarray(w1), jnp.asarray(t2), jnp.asarray(w2),
        interpret=True, **kw))
    got = tops.sinkhorn_wmd(_t(t1), _t(w1), _t(t2), _t(w2), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_sinkhorn_plain_bf16_matches_pallas():
    w1, w2, t1, t2 = _random_problems(np.random.default_rng(1), p=6)
    kw = dict(eps=0.05, eps_scaling=2, max_iters=60)
    want = np.asarray(jops.sinkhorn_wmd(
        jnp.asarray(t1), jnp.asarray(w1), jnp.asarray(t2), jnp.asarray(w2),
        bf16_matmul=True, interpret=True, **kw))
    got = tops.sinkhorn_wmd(_t(t1), _t(w1), _t(t2), _t(w2), bf16_matmul=True,
                            **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_sinkhorn_plain_empty_pairs_cost_zero():
    p, h = 4, 6
    a = np.zeros((p, h), np.float32)
    b = np.zeros((p, h), np.float32)
    a[0] = b[0] = 1.0 / h
    t = np.random.default_rng(0).normal(size=(p, h, 5)).astype(np.float32)
    cost, iters = tsk.sinkhorn_plain(_t(t), _t(a), _t(t), _t(b), eps=0.05,
                                     eps_scaling=2, max_iters=50)
    assert torch.isfinite(cost).all()
    assert torch.all(cost[1:] == 0)
    assert torch.all(iters[1:] == 2)  # one iteration per level, then frozen


@pytest.mark.parametrize("args", [(0.01, 4, 1.0), (0.05, 2, 1.0), (0.1, 1, 1.0),
                                  (0.02, 3, 0.5)])
def test_eps_schedule_matches_reference(args):
    assert tsk.eps_schedule(*args) == jsk.eps_schedule(*args)


# ---------------------------------------------------------------------------
# Top-k and distances
# ---------------------------------------------------------------------------
def _tied(rng, shape):
    return rng.integers(0, 4, size=shape).astype(np.float32)  # many ties


@pytest.mark.parametrize("k", [1, 5, 12])
def test_lex_smallest_matches_reference(k):
    rng = np.random.default_rng(k)
    d = _tied(rng, (3, 12))
    idx = np.stack([rng.permutation(12) for _ in range(3)]).astype(np.int32)
    want = jtopk.lex_smallest(jnp.asarray(d), jnp.asarray(idx), k)
    got = ttopk.lex_smallest(_t(d), _t(idx), k)
    assert np.array_equal(got.dists.numpy(), np.asarray(want.dists))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_topk_smallest_matches_lax_top_k_with_ties():
    rng = np.random.default_rng(3)
    d = _tied(rng, (4, 30))
    want = jtopk.topk_smallest(jnp.asarray(d), 9)
    got = ttopk.topk_smallest(_t(d), 9)
    assert np.array_equal(got.dists.numpy(), np.asarray(want.dists))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_streaming_fold_equals_materialized():
    rng = np.random.default_rng(4)
    d = _tied(rng, (37, 5))  # (n, B), ties across row blocks
    want = jtopk.topk_smallest_cols(jnp.asarray(d), 8)
    stk = ttopk.StreamingTopK(8)
    carry = stk.init(5)
    for lo in range(0, 37, 6):
        rows = torch.arange(lo, min(lo + 6, 37), dtype=torch.int32)
        carry = stk.update_cols(carry, _t(d[lo:lo + 6]), rows)
    assert np.array_equal(carry.indices.numpy(), np.asarray(want.indices))
    assert np.array_equal(carry.dists.numpy(), np.asarray(want.dists))
    # the row-wise orientation on the transpose gives the same carry
    rcarry = stk.init(5)
    for lo in range(0, 37, 10):
        cols = torch.arange(lo, min(lo + 10, 37), dtype=torch.int32)
        rcarry = stk.update_rows(rcarry, _t(d.T[:, lo:lo + 10]), cols)
    assert torch.equal(rcarry.indices, carry.indices)
    with pytest.raises(ValueError):
        ttopk.StreamingTopK(0)


def test_topk_from_candidates_and_merge_match_reference():
    rng = np.random.default_rng(6)
    vals = _tied(rng, (3, 10))
    cand = np.stack([rng.permutation(100)[:10] for _ in range(3)]).astype(np.int32)
    want = jtopk.topk_from_candidates(jnp.asarray(vals), jnp.asarray(cand), 4)
    got = ttopk.topk_from_candidates(_t(vals), _t(cand), 4)
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert np.array_equal(got.dists.numpy(), np.asarray(want.dists))
    parts_np = [(_tied(rng, (3, 4)), rng.integers(0, 50, (3, 4)).astype(np.int32))
                for _ in range(3)]
    want = jtopk.merge_topk([jtopk.TopK(jnp.asarray(d), jnp.asarray(i))
                             for d, i in parts_np], 5)
    got = ttopk.merge_topk([ttopk.TopK(_t(d), _t(i)) for d, i in parts_np], 5)
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))


@pytest.mark.parametrize("bf16", [False, True])
def test_sq_dists_matches_reference(bf16):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(7, 33)).astype(np.float32)
    b = rng.normal(size=(5, 33)).astype(np.float32)
    want = np.asarray(jdist.dists(jnp.asarray(a), jnp.asarray(b),
                                  bf16_matmul=bf16))
    got = tdist.dists(_t(a), _t(b), bf16_matmul=bf16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    z = tdist.safe_sqrt(torch.tensor([0.0, 4.0, -1.0]))
    assert z.tolist() == [0.0, 2.0, 0.0]


def test_sq_dists_refuses_tf32(monkeypatch):
    import repro_torch  # noqa: F401  (sets the flags)

    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        tdist.sq_dists(torch.ones(2, 3), torch.ones(2, 3))


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors take the plain versions and launch nothing
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    _build.reset_launches()
    emb, q_ids, q_w, r_ids, r_w = _fused_inputs(3)
    tops.lc_rwmd_fused_topk(*map(_t, (emb, q_ids, q_w, r_ids, r_w)), k=4,
                            fuse="kernel")
    w1, w2, t1, t2 = _random_problems(np.random.default_rng(0), p=2)
    tops.sinkhorn_wmd(_t(t1), _t(w1), _t(t2), _t(w2), max_iters=3)
    assert sum(_build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        tsp.spmm_ell_cuda(_t(r_ids), _t(r_w), torch.zeros(96, 2))


def test_kernel_sources_and_build_contract():
    """Every launcher bound in _build is exported by its source; sm_90a, no
    fast math."""
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in _build.NVCC_FLAGS)
    found = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert found == sorted(_build.SOURCES)
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces the TPU kernel src/repro/kernels/" in src
        for fn, argtypes in fns.items():
            assert f'extern "C" int {fn}(' in src
            assert argtypes[-1] is _build.P  # the stream comes last
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
