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
from repro.core import lc_rwmd as jlc
from repro.core import topk as jtopk
from repro.data.docs import DocSet as JDocSet
from repro.kernels import fused_stream as jfs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sinkhorn_wmd as jsk
from repro_torch.core import distances as tdist
from repro_torch.core import lc_rwmd as tlc
from repro_torch.core import topk as ttopk
from repro_torch.data.docs import DocSet as TDocSet
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_stream as tfs
from repro_torch.kernels import lc_rwmd_phase1 as tp1
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwmd_pairwise as trw
from repro_torch.kernels import segment_spmm as tseg
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


def _phase1_kernel_order(emb, t, valid, bf16=False):
    """B1's structure on the CPU, in float32: the wrapper's own column list
    (valid words first, in (query, word) order, and their count); tiles of
    TILE_ROWS vocab rows x TILE_COLS listed columns, a tile that starts past
    the count skipped; in each tile sq = max(|e|² + |t|² − 2·E·Tᵀ, 0) over
    the listed columns only, folded by min into Z² (filled with 3.4e38)
    once per run of one query in each thread's 8 columns (two groups of 4,
    32 apart), as the epilogue folds.  Also returns the tiles visited and
    the runs folded."""
    v, m = emb.shape
    b, h, _ = t.shape
    cols, count = tp1.valid_columns(_t(valid))
    n = int(count[0])
    assert count.dtype == torch.int32 and cols.dtype == torch.int32
    cols = cols.numpy()[:n]
    tf = t.reshape(b * h, m)
    e_op, t_op = (emb, tf) if not bf16 else (
        tdist.bf16_round(_t(emb)).numpy(), tdist.bf16_round(_t(tf)).numpy())
    e2 = (emb * emb).sum(1, dtype=np.float32)
    t2 = (tf * tf).sum(1, dtype=np.float32)
    out = np.full((v, b), np.float32(tp1.BIG), np.float32)
    tiles, runs = [], []
    for c0 in range(0, b * h, tp1.TILE_COLS):
        if c0 >= n:
            continue                       # the CTA exits at once
        cs = cols[c0:c0 + tp1.TILE_COLS]
        for r0 in range(0, v, tp1.TILE_ROWS):
            rows = slice(r0, min(r0 + tp1.TILE_ROWS, v))
            tiles.append((r0, c0))
            acc = e_op[rows] @ t_op[cs].T
            sq = e2[rows, None] + t2[cs][None, :] - np.float32(2) * acc
            sq = np.where(sq > 0, sq, np.float32(0))
            for g0 in range(0, tp1.TILE_COLS, 64):      # a warp's 64 columns
                for lc in range(8):                      # a thread's 8
                    own = [g0 + lc * 4 + j + 32 * u for u in (0, 1) for j in range(4)]
                    own = [c for c in own if c < len(cs)]
                    seg = cs[own] // h
                    for q in np.unique(seg):
                        runs.append((r0, c0 + g0 + lc * 4, int(q)))
                        out[rows, q] = np.minimum(
                            out[rows, q], sq[:, own][:, seg == q].min(1))
    return out, cols, tiles, runs


def _phase1_case(kind, rng):
    v, m, b, h = {"empty_query": (300, 40, 5, 12), "tile_ends_in_query": (260, 48, 8, 40),
                  "ragged": (300, 70, 6, 24), "bf16": (384, 96, 4, 16),
                  "short_queries": (200, 32, 60, 3)}[kind]
    emb = rng.normal(size=(v, m)).astype(np.float32)
    t = emb[rng.integers(0, v, size=b * h)].reshape(b, h, m)
    valid = (rng.random(size=(b, h)) > 0.3).astype(np.float32)
    valid[:, 0] = 1.0
    if kind == "empty_query":
        valid[2] = 0.0
    if kind == "short_queries":     # 1-3 words: a thread's columns span several
        valid[:] = 1.0
    return emb, t, valid


@pytest.mark.parametrize("kind", ["empty_query", "tile_ends_in_query", "ragged",
                                  "bf16", "short_queries"])
def test_phase1_kernel_order_matches_plain_and_pallas(kind):
    """B1's tiles over the valid columns only, min-folded per run of one
    query: against its plain version (squared) and the reference's Pallas
    kernel in interpret mode.  Cases: a query with no valid word; a column
    tile that ends inside a query; v and m not multiples of the tiles; the
    bf16 path; queries of 1-3 words, so a thread's columns hold several."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    emb, t, valid = _phase1_case(kind, rng)
    b, h = valid.shape
    bf16 = kind == "bf16"
    got, cols, tiles, runs = _phase1_kernel_order(emb, t, valid, bf16=bf16)
    # the column list: exactly the valid words, in (query, word) order
    assert cols.tolist() == np.flatnonzero(valid.reshape(-1) > 0).tolist()
    assert {c0 for _, c0 in tiles} == set(range(0, len(cols), tp1.TILE_COLS))
    if kind == "empty_query":
        assert 2 not in {q for *_, q in runs}
        assert np.all(got[:, 2] == np.float32(tp1.BIG))
    if kind == "tile_ends_in_query":
        q_at = cols // h
        edge = tp1.TILE_COLS
        assert len(cols) > edge and q_at[edge - 1] == q_at[edge]
    if kind == "ragged":
        assert emb.shape[0] % tp1.TILE_ROWS and emb.shape[1] % 16
    if kind == "short_queries":
        assert max(len({q for r0, s0, q in runs if (r0, s0) == key})
                   for key in {(r0, s0) for r0, s0, _ in runs}) >= 4
    plain = tp1.phase1_sq_plain(_t(emb), _t(t), _t(valid), bf16_matmul=bf16).numpy()
    # squared space: the gram form's error scales with the norms
    scale = (emb * emb).sum(1)[:, None] + ((t * t).sum(2) * valid).max(1)[None, :]
    assert np.all(np.abs(got - plain) <= 1e-5 * scale)
    want = np.asarray(jops.lc_rwmd_phase1_pregathered(
        jnp.asarray(emb), jnp.asarray(t), jnp.asarray(valid), block_v=128,
        bf16_matmul=bf16, interpret=True))
    # atol floor: sqrt(eps·|e|²) gram-expansion noise on near-zero distances
    np.testing.assert_allclose(np.sqrt(got), want, rtol=1e-4, atol=2.5e-2)


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
    """Every mode of the reference is ported; only an unknown one raises."""
    rng = np.random.default_rng(17)
    ids, w = _mk_ell(rng, 9, 5, 40)
    z = rng.normal(size=(40, 3)).astype(np.float32)
    if mode == "bogus":
        with pytest.raises(ValueError, match="unknown spmm mode"):
            tops.spmm_ell(_t(ids), _t(w), _t(z), mode=mode)
        return
    got = tops.spmm_ell(_t(ids), _t(w), _t(z), mode=mode)
    want = tops.spmm_ell(_t(ids), _t(w), _t(z), mode="blocked")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,h,v,b,block_v", [
    (16, 8, 256, 4, 64),
    (13, 8, 200, 3, 64),    # n AND v padded in the reference
    (8, 4, 128, 9, 128),
    (40, 6, 1100, 5, 256),  # more than one of the port's 512-row subtiles
])
def test_spmm_dense_plain_matches_pallas(n, h, v, b, block_v):
    rng = np.random.default_rng(n * 17 + h + v + b)
    ids, w = _mk_ell(rng, n, h, v)
    z = rng.normal(size=(v, b)).astype(np.float32)
    want = np.asarray(jops.spmm_ell(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(z), mode="dense",
                                    block_v=block_v, interpret=True))
    got = tops.spmm_ell(_t(ids), _t(w), _t(z), mode="dense").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    small = tsp.spmm_ell_dense_plain(_t(ids), _t(w), _t(z), block_v=block_v)
    np.testing.assert_allclose(small.numpy(), want, rtol=1e-5, atol=1e-5)


def _dense_kernel_order(ids, w, z, bv=tsp.DENSE_BV):
    """B6a's sums in the CUDA kernel's order, on the CPU, in float32: per
    row, its slots of nonzero weight and an id in [0, v) bucketed by (vocab
    subtile, slot), only the non-empty subtiles visited, in ascending order;
    each subtile's slots summed in slot order into a partial, added to the
    row's sum when the subtile ends (the reference's out += A @ Z_tile).
    Also returns each row's subtile sequence."""
    n, h = ids.shape
    v = z.shape[0]
    out = np.zeros((n, z.shape[1]), np.float32)
    visits = []
    for i in range(n):
        slots = sorted((int(ids[i, p]) // bv, p) for p in range(h)
                       if w[i, p] != 0 and 0 <= ids[i, p] < v)
        acc = np.zeros(z.shape[1], np.float32)
        part = np.zeros_like(acc)
        seq = []
        for sub, p in slots:
            if seq and sub != seq[-1]:
                acc = acc + part
                part = np.zeros_like(acc)
            if not seq or sub != seq[-1]:
                seq.append(sub)
            part = part + np.float32(w[i, p]) * z[ids[i, p]]
        out[i] = acc + part
        visits.append(seq)
    return out, visits


def _dense_case(kind, rng):
    n, h, v, b = {"random": (40, 12, 1700, 5), "skewed": (13, 16, 2100, 3),
                  "padding_rows": (21, 9, 1200, 4), "wide_rows": (9, 80, 1600, 2),
                  "out_of_range_ids": (19, 24, 1300, 4)}[kind]
    ids, w = _mk_ell(rng, n, h, v)
    if kind == "skewed":          # every slot in one subtile (3 of 2100 // 512)
        ids = rng.integers(3 * tsp.DENSE_BV, 4 * tsp.DENSE_BV,
                           size=(n, h)).astype(np.int32)
    if kind == "padding_rows":    # all-zero rows, as ELL padding docs
        w[::4] = 0.0
    if kind == "out_of_range_ids":  # ids < 0 or >= v, with nonzero weights
        bad = rng.random(size=(n, h)) < 0.25
        ids[bad] = rng.choice([-1, -(2**31), v, v + 300, 2**31 - 1],
                              size=int(bad.sum()))
        w[bad] = rng.uniform(0.5, 1.0, size=int(bad.sum()))
    return ids, w, rng.normal(size=(v, b)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "skewed", "padding_rows",
                                  "wide_rows", "out_of_range_ids"])
def test_spmm_dense_kernel_order_matches_plain_and_pallas(kind):
    """B6a's bucketed order (n not a multiple of the kernel's 8 rows a CTA;
    rows wider than 64 slots take the kernel's shared-memory path; a slot
    whose id lies outside [0, v) adds nothing) computes the dense
    formulation: against its plain version and the reference's one-hot
    Pallas kernel."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    ids, w, z = _dense_case(kind, rng)
    got, visits = _dense_kernel_order(ids, w, z)
    for i, seq in enumerate(visits):   # the non-empty subtiles, ascending
        adds = (w[i] != 0) & (ids[i] >= 0) & (ids[i] < z.shape[0])
        assert seq == sorted(set((ids[i][adds] // tsp.DENSE_BV).tolist()))
    if kind == "skewed":
        assert all(seq == [3] for seq in visits if seq)
    if kind == "padding_rows":
        assert not any(visits[::4]) and not got[::4].any()
    plain = tsp.spmm_ell_dense_plain(_t(ids), _t(w), _t(z)).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    want = np.asarray(jops.spmm_ell(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(z), mode="dense",
                                    block_v=tsp.DENSE_BV, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,h,v,b", [(24, 8, 128, 6), (7, 13, 300, 2)])
def test_spmm_naive_plain_matches_pallas(n, h, v, b):
    rng = np.random.default_rng(n * 19 + h + v + b)
    ids, w = _mk_ell(rng, n, h, v)
    z = rng.normal(size=(v, b)).astype(np.float32)
    want = np.asarray(jops.spmm_ell(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(z), mode="naive",
                                    interpret=True))
    got = tops.spmm_ell(_t(ids), _t(w), _t(z), mode="naive").numpy()
    # the reference's own bar between its naive and blocked kernels
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# B5 fused vocab chunk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cv,bf16", [(64, False), (128, False), (64, True)])
def test_fused_chunk_plain_matches_pallas(cv, bf16):
    rng = np.random.default_rng(cv + bf16)
    m, b, h, n, h1 = 32, 3, 5, 16, 6
    emb_c = rng.normal(size=(cv, m)).astype(np.float32)
    q_t = rng.normal(size=(b, h, m)).astype(np.float32)
    valid = (rng.random((b, h)) > 0.3).astype(np.float32)
    valid[:, 0] = 1.0
    ids = rng.integers(-cv, 2 * cv, size=(n, h1))
    w = rng.uniform(0, 1, size=(n, h1)).astype(np.float32)
    inb = (ids >= 0) & (ids < cv)
    ids_rel = np.clip(ids, 0, cv - 1).astype(np.int32)
    w_m = (w * inb).astype(np.float32)
    want = np.asarray(jfs.fused_lc_rwmd_chunk_pallas(
        jnp.asarray(emb_c), jnp.asarray(q_t), jnp.asarray(valid),
        jnp.asarray(ids_rel), jnp.asarray(w_m), block_v=32, bf16_matmul=bf16,
        interpret=True))[:, :b]
    d0 = rng.normal(size=(n, b)).astype(np.float32)
    d = _t(d0)
    # the port takes the vocab ids as they are, with the chunk's offset
    lo = 3 * cv
    out = tfs.fused_chunk(_t(emb_c), _t(q_t), _t(valid),
                          _t((ids + lo).astype(np.int32)), _t(w), lo, d,
                          bf16_matmul=bf16)
    assert out is d  # accumulated in place
    tol = dict(rtol=5e-2, atol=0.7) if bf16 else dict(rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(d.numpy() - d0, want, **tol)


@pytest.mark.parametrize("kind", ["untouched", "last_chunk", "d_in"])
def test_fused_chunk_plain_matches_pallas_at_the_edges(kind):
    """A chunk that no doc touches (D comes back as it went in), the padded
    last chunk of a vocabulary (zero rows past v, as ops.lc_rwmd_fused pads
    it) and a non-zero D in, against the Pallas kernel's partial."""
    rng = np.random.default_rng({"untouched": 1, "last_chunk": 2, "d_in": 3}[kind])
    cv, m, b, h, n, h1 = 64, 32, 4, 6, 24, 8
    v = 3 * cv + 20 if kind == "last_chunk" else 4 * cv
    emb = rng.normal(size=(v, m)).astype(np.float32)
    lo = 3 * cv if kind == "last_chunk" else 2 * cv
    emb_c = np.zeros((cv, m), np.float32)
    emb_c[:min(cv, v - lo)] = emb[lo:lo + cv]
    q_t = rng.normal(size=(b, h, m)).astype(np.float32)
    valid = (rng.random((b, h)) > 0.3).astype(np.float32)
    valid[:, 0] = 1.0
    ids = rng.integers(0, v, size=(n, h1)).astype(np.int32)
    if kind == "untouched":
        ids[(ids >= lo) & (ids < lo + cv)] -= cv
    w = rng.uniform(0, 1, size=(n, h1)).astype(np.float32)
    w[rng.random(size=w.shape) < 0.3] = 0.0
    inb = (ids >= lo) & (ids < lo + cv)
    assert inb.any() != (kind == "untouched")
    want = np.asarray(jfs.fused_lc_rwmd_chunk_pallas(
        jnp.asarray(emb_c), jnp.asarray(q_t), jnp.asarray(valid),
        jnp.asarray(np.clip(ids - lo, 0, cv - 1).astype(np.int32)),
        jnp.asarray((w * inb).astype(np.float32)), block_v=32,
        interpret=True))[:, :b]
    d0 = (np.zeros((n, b), np.float32) if kind == "last_chunk"
          else rng.normal(size=(n, b)).astype(np.float32))
    d = _t(d0)
    tfs.fused_chunk(_t(emb_c), _t(q_t), _t(valid), _t(ids), _t(w), lo, d)
    if kind == "untouched":
        assert np.array_equal(d.numpy(), d0)
    np.testing.assert_allclose(d.numpy() - d0, want, rtol=1e-4, atol=1e-2)


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


def _slot_key(e):
    """B3's order of a (value, id) slot: its value's key (ascending, +inf
    after every finite value, NaN after +inf, -0 as +0), an unfilled slot
    (id -1) after every value; then the id."""
    v, i = e
    return ((2, 0.0) if i < 0 else (1, 0.0) if v != v else (0, float(v)), i)


def _lex_merge(a, b, k):
    """The k smallest of two (value, id) lists, in B3's order."""
    return sorted(a + b, key=_slot_key)[:k]


def _topk_filter_order(d, k, *, n_real=None, n_sm=2, cap=tfs.FLUSH_CAP,
                       step=tfs.STEP_ROWS):
    """B3's fold on the CPU over a D (n, B) float32: the wrapper's own doc
    ranges (``tfs.cta_rows``), each walked in steps of ``step`` rows; every
    (row, query) of a step tested against the query's threshold (its
    carry's k-th key, above every value while not full), strictly, as of
    the step's start; survivors into a buffer of ``cap``, flushed into the
    sorted carry when a count exceeds ``cap - step`` and at the range's
    end; then the CTAs' partials merged pairwise in (value, id) order
    (:func:`_slot_key`).  Each level's lists are ``tfs.list_widths`` long
    (a CTA's carry no longer than its rows).  Empty slots are (3.4e38, -1).
    Also returns the flushes per CTA."""
    big = np.float32(tp1.BIG)
    n, b = d.shape
    n_rows = n if n_real is None else min(n, n_real)
    kk = min(k, n_rows)
    rows, n_ctas = tfs.cta_rows(n_rows, n_sm)
    widths = tfs.list_widths(kk, rows, n_ctas)
    kw = widths[0]
    parts, flushes = [], []
    for cta in range(n_ctas):
        r0, r1 = cta * rows, min(n_rows, (cta + 1) * rows)
        carry = [[(big, -1)] * kw for _ in range(b)]
        thr = [_slot_key((big, -1))[0]] * b
        buf = [[] for _ in range(b)]
        nfl = 0

        def flush():
            for q in range(b):
                if buf[q]:
                    carry[q] = _lex_merge(carry[q], buf[q], kw)
                    thr[q] = _slot_key(carry[q][-1])[0]
                    buf[q] = []

        for tile in range(r0, r1, step):
            for r in range(tile, min(tile + step, r1)):
                for q in range(b):
                    if _slot_key((d[r, q], r))[0] < thr[q]:
                        buf[q].append((d[r, q], r))
            assert max(map(len, buf)) <= cap           # never overflows
            if max(map(len, buf)) > cap - step:
                flush()
                nfl += 1
        flush()
        parts.append(carry)
        flushes.append(nfl)
    for w in widths[1:]:    # the pairwise merge launches
        pad = [(big, -1)] * w
        parts = [[_lex_merge(x, y if i + 1 < len(parts) else pad, w)
                  for x, y in zip(parts[i], parts[min(i + 1, len(parts) - 1)])]
                 for i in range(0, len(parts), 2)]
    assert len(parts) == 1 and len(parts[0][0]) == kk
    vals = np.array([[e[0] for e in c] for c in parts[0]], np.float32)
    ids = np.array([[e[1] for e in c] for c in parts[0]], np.int32)
    return vals, ids, flushes


@pytest.mark.parametrize("n_real,k", [(700_000, 32), (700_000, 256),
                                      (700_000, 700_000), (3000, 3000),
                                      (50_000, 49_000), (40, 7)])
def test_list_widths_end_at_k_and_bound_the_partials(n_real, k):
    """B3's lists: the last level holds k; no level holds more than the
    CTAs' rows (about n_real) or k entries a query per list, so the
    partials of k = n_real fit where k lists per CTA would not."""
    rows, n_ctas = tfs.cta_rows(n_real, 132)
    widths = tfs.list_widths(k, rows, n_ctas)
    assert widths[-1] == k and widths[0] == min(k, rows)
    n_lists = n_ctas
    for w in widths:
        assert w <= k and n_lists * w <= max(n_ctas * rows, 2 * k)
        n_lists = -(-n_lists // 2)
    assert all(b <= 2 * a for a, b in zip(widths, widths[1:]))


def _topk_case(kind, rng):
    """(emb, q_ids, q_w, r_ids, r_w, k, n_real, cap) for one case.

    Small-integer embeddings: phase 1's gram form is then exact in both
    packages, so Z agrees bit for bit and D only by the order of its sums;
    such random inputs have no near ties, so the ids agree exactly."""
    n, v, m, b, h = 300, 128, 16, 5, 6
    emb = rng.integers(-3, 4, size=(v, m)).astype(np.float32)
    q_ids, q_w = _mk_queries(rng, b, h, v)
    r_ids, r_w = _mk_ell(rng, n, 8, v, pad=0.25)
    r_w[:, 0] = np.maximum(r_w[:, 0], 0.1)  # no empty resident docs
    k, n_real, cap = 32, None, tfs.FLUSH_CAP
    if kind == "ties":             # each doc four times: exact ties
        r_ids, r_w = np.repeat(r_ids[:75], 4, 0), np.repeat(r_w[:75], 4, 0)
    elif kind.startswith("k"):
        k = int(kind[1:])
    elif kind == "n_real":
        n_real = 201
    elif kind == "first_step_flush":
        cap, k = tfs.STEP_ROWS, 128   # full after one step: flush every step
    elif kind == "huge":
        # Query 1 has no valid word, so Z[:, 1] = sqrt(3.4e38) = 1.8439e19;
        # all but 30 rows carry weight 1.8445e19 on a word no query holds:
        # D = 3.4011e38 for query 1 (finite, >= 3.4e38) and ~1e20, tied,
        # for the others.
        q_w[1] = 0.0
        spare = sorted(set(range(v)) - set(q_ids.reshape(-1).tolist()))[0]
        heavy = np.arange(n) % 10 != 0
        r_ids[heavy, 0], r_w[heavy, 0] = spare, 1.8445e19
        k = 128
    return emb, q_ids, q_w, r_ids, r_w, k, n_real, cap


@pytest.mark.parametrize("kind", ["ties", "k1", "k32", "k128", "k200",
                                  "k300", "n_real", "first_step_flush", "huge"])
def test_topk_filter_order_matches_plain_and_pallas(kind):
    """B3's filter, buffers, flushes and merges keep the k smallest (value,
    doc id) pairs: against the plain fold (values, ids) and the reference's
    Pallas kernel in interpret mode (equal ids).  Cases: heavy ties; k of
    1, 32 and 128; k of 200 and 300 (= n), above a CTA's 96 rows, so the
    partials are narrower than k and the merges widen them; n_real < n; a
    buffer that fills in the first step; finite D values >= 3.4e38, which
    the kernel ranks as the plain fold does (the reference's kernel drops
    them: its slots there are left out of the comparison)."""
    emb, q_ids, q_w, r_ids, r_w, k, n_real, cap = _topk_case(
        kind, np.random.default_rng(0))
    n = r_ids.shape[0]
    valid = (q_w > 0).astype(np.float32)
    t = emb[q_ids]
    z = torch.sqrt(torch.clamp(
        tp1.phase1_sq_plain(_t(emb), _t(t), _t(valid)), min=0.0))
    d = tsp.spmm_ell_plain(_t(r_ids), _t(r_w), z).numpy()
    vals, ids, flushes = _topk_filter_order(d, k, n_real=n_real, cap=cap)
    n_rows = n if n_real is None else n_real
    rows, n_ctas = tfs.cta_rows(n_rows, 2)
    assert len(flushes) == n_ctas > 1               # several CTAs
    if kind == "first_step_flush":                  # a flush after every step
        assert flushes == [-(-(min(n_rows, (c + 1) * rows) - c * rows)
                             // tfs.STEP_ROWS) for c in range(n_ctas)]
    kk = min(k, n_rows)
    pv, pi = tfs.phase2_topk_plain(_t(r_ids), _t(r_w), z, k, n_real=n_real)
    pv, pi = pv.numpy(), pi.numpy()
    np.testing.assert_allclose(vals, pv, rtol=1e-6, atol=1e-6)
    assert np.array_equal(ids, pi)
    # the reference's kernel drops a value >= 3.4e38; B3 ranks it
    dropped = pv >= np.float32(tp1.BIG)
    if kind == "huge":
        assert dropped[1].any() and not dropped[[0, 2, 3, 4]].any()
        assert np.all(ids[1] >= 0)
    if kind == "ties":
        same = vals[:, 1:] == vals[:, :-1]
        assert same.any() and np.all(ids[:, 1:][same] > ids[:, :-1][same])
    pad = -n % 8   # the reference kernel's 8-row doc tiles
    jv, ji = jfs.fused_lc_rwmd_topk_pallas(
        jnp.asarray(np.pad(emb, ((0, 0), (0, 128 - emb.shape[1])))),
        jnp.asarray(np.pad(t, ((0, 0), (0, 0), (0, 128 - t.shape[2])))),
        jnp.asarray(valid), jnp.asarray(np.pad(r_ids, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(r_w.astype(np.float32), ((0, pad), (0, 0)))),
        k=kk, n_real=n_rows, block_v=128, interpret=True)
    jv, ji = np.asarray(jv)[:kk, :5].T, np.asarray(ji)[:kk, :5].T
    np.testing.assert_allclose(vals[~dropped], jv[~dropped], rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(ids[~dropped], ji[~dropped])
    assert np.all(ji[dropped] == -1)


@pytest.mark.parametrize("k", [5, 129, 256, 400])
@pytest.mark.parametrize("kind", ["masks", "ties", "all_true", "all_but_k"])
def test_streaming_phase2_masks_match_reference(kind, k):
    """``q_gid`` (self-exclusion) and ``row_valid`` (tombstones) against the
    reference's jnp fold, at k of 5, above the kernel's shared-memory carry
    (129, 256) and above n (400 > 300: every row ranked, the masked ones
    left as (+inf, -1)).  Cases: random masks; every doc three times (exact
    ties, ordered by doc id); an all-True mask, equal to None; every row
    tombstoned but k."""
    rng = np.random.default_rng(k + 10 * len(kind))
    n, v, b = 300, 70, 4
    r_ids, r_w = _mk_ell(rng, n, 6, v)
    if kind == "ties":
        r_ids, r_w = np.repeat(r_ids[:100], 3, 0), np.repeat(r_w[:100], 3, 0)
    z = np.abs(rng.normal(size=(v, b))).astype(np.float32)
    q_gid = rng.integers(0, n, b).astype(np.int32)
    if kind == "all_true":
        live = np.ones(n, bool)
    elif kind == "all_but_k":
        live = np.zeros(n, bool)
        live[rng.choice(n, min(k, n), replace=False)] = True
        q_gid = None
    else:
        live = rng.random(n) > 0.3
    jkw = dict(row_block=64, row_valid=jnp.asarray(live),
               q_gid=None if q_gid is None else jnp.asarray(q_gid))
    tkw = dict(row_block=64, row_valid=_t(live),
               q_gid=None if q_gid is None else _t(q_gid))
    jd, ji = jops.streaming_phase2_topk(jnp.asarray(r_ids), jnp.asarray(r_w),
                                        jnp.asarray(z), k, **jkw)
    td, ti = tops.streaming_phase2_topk(_t(r_ids), _t(r_w), _t(z), k, **tkw)
    assert td.shape == (b, min(k, n)) and ti.dtype == torch.int32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    ti = ti.numpy()
    got = ti >= 0
    assert np.all(live[ti[got]])
    if q_gid is not None:
        assert not np.any((ti == q_gid[:, None]) & got)
    if kind == "ties":
        tv = td.numpy()
        same = (tv[:, 1:] == tv[:, :-1]) & np.isfinite(tv[:, 1:])
        assert same.any() and np.all(ti[:, 1:][same] > ti[:, :-1][same])
    if kind == "all_true":
        nd, ni = tops.streaming_phase2_topk(_t(r_ids), _t(r_w), _t(z), k,
                                            row_block=64, q_gid=_t(q_gid))
        assert torch.equal(nd, td) and np.array_equal(ni.numpy(), ti)
    if kind == "all_but_k":   # exactly the live rows, all finite
        assert np.array_equal(np.sort(ti, 1), np.tile(np.flatnonzero(live), (b, 1)))
        assert np.all(np.isfinite(td.numpy()))


# ---------------------------------------------------------------------------
# B7 quadratic RWMD and its d21 mode (the symmetric fold's swapped direction)
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    """fmaf in float32: the product and sum taken exactly, rounded once
    (up to a double rounding that does not show at these tolerances); a
    sum past float32's range is inf, as on the card."""
    with np.errstate(over="ignore"):
        r = np.add(np.multiply(a, b, dtype=np.float64), c, dtype=np.float64)
        return r.astype(np.float32) if isinstance(r, np.ndarray) else np.float32(r)


def _rwmd_kernel_order(emb, r_ids, r_w, q_ids, q_w, *, full, bf16=False,
                       ctas=3):
    """B7's structure on the CPU, in float32.  The lists: each doc's first
    valid row (doc_start), the valid (doc, word) slots, the valid (query,
    word) columns and each group's first column.  Per group of
    QUERY_GROUP queries, ``ctas`` CTAs own whole docs by a binary search of
    doc_start at multiples of the rows over ``ctas``; each writes its empty
    docs, then walks its rows in tiles of TILE_ROWS cut at TILE_DOCS docs,
    and per tile the group's columns in tiles of TILE_COLS: squared
    distances in gram form, row minima per query (full) and column minima
    per doc, the d21 terms of each doc that ends in the tile (column order,
    fmaf), the column minima of a doc that goes on kept in the CTA's carry;
    then d12 over the tile's rows in slot order (its sum carried for a doc
    that goes on) and the outputs.  Returns (out, stats)."""
    f32, big = np.float32, np.float32(trw.BIG)
    n, h1 = r_ids.shape
    b, h2 = q_ids.shape
    qg, bm, bn, dmax = (trw.QUERY_GROUP, trw.TILE_ROWS, trw.TILE_COLS,
                        trw.TILE_DOCS)
    cnt = (r_w > 0).sum(1)
    doc_start = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    rows = np.flatnonzero(r_w.reshape(-1) > 0)
    cols = np.flatnonzero(q_w.reshape(-1) > 0)
    groups = -(-b // qg)
    gcol = [int(np.searchsorted(cols, g * qg * h2)) for g in range(groups)]
    gcol.append(len(cols))
    e_op = tdist.bf16_round(_t(emb)).numpy() if bf16 else emb
    norm = (emb * emb).sum(1, dtype=f32)
    rid_all, rw_all = r_ids.reshape(-1), r_w.reshape(-1)
    qid_all, qw_all = q_ids.reshape(-1), q_w.reshape(-1)
    out = np.full((n, b), np.nan, f32)
    stats = dict(tiles=0, open_in=0, docs_per_tile=0, cut_by_docs=0,
                 empty_written=0, ranges=set())
    nr = int(doc_start[n])
    for g in range(groups):
        qb, nqg = g * qg, min(qg, b - g * qg)
        gc0, gc1 = gcol[g], gcol[g + 1]
        empty = np.zeros(qg, f32)
        for q in range(nqg):
            w2 = q_w[qb + q]
            s = f32(0)
            for c in range(h2):
                if w2[c] > 0:
                    s = _fma(w2[c], big, s)
            empty[q] = s if full else (np.inf if (w2 > 0).any() else 0.0)
        for cta in range(ctas):
            d_lo = 0 if cta == 0 else int(np.searchsorted(doc_start, nr * cta // ctas))
            d_hi = n if cta == ctas - 1 else int(np.searchsorted(
                doc_start, nr * (cta + 1) // ctas))
            if d_lo >= d_hi:
                continue
            stats["ranges"].add((d_lo, d_hi))
            for d in range(d_lo, d_hi):
                if cnt[d] == 0:
                    out[d, qb:qb + nqg] = empty[:nqg]
                    stats["empty_written"] += 1
            carry_col = np.full(qg * h2, np.nan, f32)   # never read unset
            carry_d12 = np.full(qg, np.nan, f32)
            r0, r_end = int(doc_start[d_lo]), int(doc_start[d_hi])
            while r0 < r_end:
                d0 = rows[r0] // h1
                r1 = min(r0 + bm, r_end, int(doc_start[min(d0 + dmax, d_hi)]))
                stats["cut_by_docs"] += r1 < min(r0 + bm, r_end)
                dl = rows[r1 - 1] // h1
                nd = dl - d0 + 1
                open_in = doc_start[d0] < r0
                open_out = doc_start[dl + 1] > r1
                stats["tiles"] += 1
                stats["open_in"] += open_in
                stats["docs_per_tile"] = max(stats["docs_per_tile"], nd)
                slots = rows[r0:r1]
                rdoc = slots // h1 - d0
                rw, rid = rw_all[slots], rid_all[slots]
                dstart = np.clip(doc_start[d0:d0 + nd + 1], r0, r1) - r0
                d21 = np.zeros((nd, qg), f32)
                d12 = np.zeros((nd, qg), f32)
                if open_in:
                    d12[0] = carry_d12
                rowmin = np.full((r1 - r0, qg), big, f32)
                for cb in range(gc0, gc1, bn):
                    cl = cols[cb:min(cb + bn, gc1)]
                    cq = cl // h2 - qb
                    cw, cid = qw_all[cl], qid_all[cl]
                    acc = e_op[rid] @ e_op[cid].T
                    sq = np.maximum(norm[rid][:, None] + norm[cid][None, :]
                                    - f32(2) * acc, f32(0))
                    if full:
                        for q in np.unique(cq):
                            rowmin[:, q] = np.minimum(rowmin[:, q],
                                                      sq[:, cq == q].min(1))
                    colmin = np.full((nd, len(cl)), big, f32)
                    for d in range(nd):
                        if (rdoc == d).any():
                            colmin[d] = sq[rdoc == d].min(0)
                    ccar = carry_col[cb - gc0:cb - gc0 + len(cl)]
                    for d in range(nd):
                        if (d == nd - 1 and open_out) or dstart[d] == dstart[d + 1]:
                            continue
                        mins = colmin[d] if not (d == 0 and open_in) else \
                            np.minimum(colmin[d], ccar)
                        for c in range(len(cl)):
                            d21[d, cq[c]] = _fma(cw[c], np.sqrt(mins[c]),
                                                 d21[d, cq[c]])
                    if open_out:
                        new = colmin[nd - 1]
                        if nd == 1 and open_in:
                            new = np.minimum(new, ccar)
                        carry_col[cb - gc0:cb - gc0 + len(cl)] = new
                if full:
                    for d in range(nd):
                        for q in range(nqg):
                            for r in range(dstart[d], dstart[d + 1]):
                                mn = big if rowmin[r, q] == big else np.sqrt(rowmin[r, q])
                                d12[d, q] = _fma(rw[r], mn, d12[d, q])
                for d in range(nd):
                    if dstart[d] == dstart[d + 1]:
                        continue
                    if d == nd - 1 and open_out:
                        carry_d12 = d12[d].copy()
                        continue
                    val = np.maximum(d12[d], d21[d]) if full else d21[d]
                    out[d0 + d, qb:qb + nqg] = val[:nqg]
                r0 = r1
    return out, stats


def _rwmd_case(kind, rng):
    """(emb, r_ids, r_w, q_ids, q_w, ctas) for one case."""
    n, h1, b, h2, m, v, ctas = {
        "straddle": (40, 20, 5, 9, 16, 96, 3),      # docs across row tiles
        "empty": (30, 12, 6, 7, 16, 64, 2),
        "h160": (6, 160, 3, 160, 8, 512, 2),        # docs over three tiles
        "bf16": (24, 16, 4, 10, 32, 128, 2),
        "short_docs": (120, 3, 4, 5, 16, 64, 2),    # the 16-docs cut
        "groups": (20, 10, 40, 6, 8, 64, 2),        # two query groups
    }[kind]
    emb = rng.normal(size=(v, m)).astype(np.float32)
    r_ids, r_w = _mk_ell(rng, n, h1, v, pad=0.3)
    r_w[:, 0] = np.maximum(r_w[:, 0], 0.1)
    q_ids, q_w = _mk_queries(rng, b, h2, v)
    if kind == "empty":
        r_w[4] = 0.0
        q_w[1] = 0.0
    return emb, r_ids, r_w, q_ids, q_w, ctas


@pytest.mark.parametrize("kind", ["straddle", "empty", "h160", "bf16",
                                  "short_docs", "groups"])
def test_rwmd_kernel_order_matches_plain_and_pallas(kind):
    """B7's lists, CTA doc ranges, tiles, carries and sums, in both modes:
    max(d12, d21) against its plain version and the reference's Pallas
    kernel in interpret mode; d21 against rwmd_d21_plain.  Cases: docs
    that straddle row tiles; an empty resident doc and an empty query;
    docs of 160 words (three tiles) and queries of 160 (two column tiles);
    bf16; 3-word docs, so tiles are cut at 16 docs; 40 queries, two
    groups."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    emb, r_ids, r_w, q_ids, q_w, ctas = _rwmd_case(kind, rng)
    bf16 = kind == "bf16"
    args = tuple(map(_t, (emb, r_ids, r_w, q_ids, q_w)))
    full, st = _rwmd_kernel_order(emb, r_ids, r_w, q_ids, q_w, full=True,
                                  bf16=bf16, ctas=ctas)
    d21, st21 = _rwmd_kernel_order(emb, r_ids, r_w, q_ids, q_w, full=False,
                                   bf16=bf16, ctas=ctas)
    assert st == st21 and len(st["ranges"]) > 1      # several CTAs own docs
    assert not np.isnan(full).any() and not np.isnan(d21).any()
    if kind in ("straddle", "h160"):
        assert st["open_in"] > 0                     # a doc goes on
    if kind == "h160":
        assert st["tiles"] >= 3 * len(st["ranges"])
    if kind == "short_docs":
        assert st["cut_by_docs"] > 0 and st["docs_per_tile"] == trw.TILE_DOCS
    if kind == "empty":
        assert st["empty_written"] > 0
        assert np.all(np.isinf(d21[4][q_w.sum(1) > 0])) and np.all(d21[:, 1] == 0)
        assert full[4, 1] == 0.0 and full[4, 0] > 3e38 and full[0, 1] > 3e38
    plain = trw.rwmd_pairwise_plain(*args, bf16_matmul=bf16).numpy()
    np.testing.assert_allclose(full, plain, rtol=1e-4, atol=2.5e-2)
    plain21 = trw.rwmd_d21_plain(*args, bf16_matmul=bf16).numpy()
    np.testing.assert_allclose(d21, plain21, rtol=1e-4, atol=2.5e-2)
    want = np.asarray(jops.rwmd_pairwise(
        *map(jnp.asarray, (emb, r_ids, r_w, q_ids, q_w)), bf16_matmul=bf16,
        interpret=True))
    np.testing.assert_allclose(full, want, rtol=1e-4, atol=2.5e-2)


def test_rwmd_d21_plain_matches_reference_swapped_direction():
    """d21 is the reference's one-sided LC-RWMD with the sets swapped (the
    queries moved into the resident docs), and the port's slab fold ranks
    max(D1, d21): the engine's symmetric streaming top-k equals the top-k
    of that matrix, and its dense bound is that matrix."""
    rng = np.random.default_rng(21)
    n, h1, b, h2, m, v = 40, 8, 5, 6, 16, 64
    emb = rng.normal(size=(v, m)).astype(np.float32)
    r_ids, r_w = _mk_ell(rng, n, h1, v)
    r_w[:, 0] = np.maximum(r_w[:, 0], 0.1)
    q_ids, q_w = _mk_queries(rng, b, h2, v)
    got = tops.rwmd_d21(*map(_t, (emb, r_ids, r_w, q_ids, q_w))).numpy()
    want = np.asarray(jlc.lc_rwmd_one_sided(
        JDocSet(ids=jnp.asarray(q_ids), weights=jnp.asarray(q_w)),
        JDocSet(ids=jnp.asarray(r_ids), weights=jnp.asarray(r_w)),
        jnp.asarray(emb))).T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2.5e-2)
    docs = TDocSet(ids=_t(r_ids), weights=_t(r_w))
    q = TDocSet(ids=_t(q_ids), weights=_t(q_w))
    eng = tlc.LCRWMDEngine(docs, _t(emb), device="cpu", row_block=16)
    dense = torch.maximum(eng.one_sided(q), torch.tensor(got))
    torch.testing.assert_close(eng.symmetric(q), dense, rtol=1e-6, atol=1e-6)
    stream = eng.symmetric_topk_streaming(q, 12)
    top = ttopk.topk_smallest_cols(dense, 12)
    assert torch.equal(stream.indices, top.indices)
    torch.testing.assert_close(stream.dists, top.dists, rtol=1e-6, atol=1e-6)


def test_symmetric_fold_empty_doc_is_inf_not_nan():
    """An empty resident doc against padded queries: the port's swapped
    direction is +inf (a padded word adds 0), where the reference's
    one-sided pass gives 0 · inf = NaN; both symmetric streaming top-ks
    rank it last, and agree on every other slot."""
    rng = np.random.default_rng(22)
    n, h1, b, h2, m, v = 40, 8, 5, 6, 16, 64
    emb = rng.normal(size=(v, m)).astype(np.float32)
    r_ids, r_w = _mk_ell(rng, n, h1, v)
    r_w[:, 0] = np.maximum(r_w[:, 0], 0.1)
    r_w[7] = 0.0
    q_ids, q_w = _mk_queries(rng, b, h2, v)
    assert (q_w == 0).any()                          # padded query words
    got = tops.rwmd_d21(*map(_t, (emb, r_ids, r_w, q_ids, q_w))).numpy()
    assert np.all(np.isinf(got[7])) and not np.isnan(got).any()
    jr = JDocSet(ids=jnp.asarray(r_ids), weights=jnp.asarray(r_w))
    jq = JDocSet(ids=jnp.asarray(q_ids), weights=jnp.asarray(q_w))
    want = np.asarray(jlc.lc_rwmd_one_sided(jq, jr, jnp.asarray(emb))).T
    assert np.all(np.isnan(want[7][(q_w == 0).any(1)]))
    eng = tlc.LCRWMDEngine(TDocSet(ids=_t(r_ids), weights=_t(r_w)), _t(emb),
                           device="cpu", row_block=16)
    ref = jlc.LCRWMDEngine(jr, jnp.asarray(emb))
    k = n - 1
    a = eng.symmetric_topk_streaming(TDocSet(ids=_t(q_ids), weights=_t(q_w)), k)
    r = ref.symmetric_topk_streaming(jq, k)
    assert not torch.isnan(a.dists).any() and not (a.indices == 7).any()
    np.testing.assert_allclose(a.dists.numpy(), np.asarray(r.dists),
                               rtol=1e-4, atol=2.5e-2)
    assert np.array_equal(a.indices.numpy(), np.asarray(r.indices))


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


def _ragged_problems(kind, p=8, h1=12, h2=10, m=16, seed=5):
    """Pairs whose valid counts differ widely: one valid word a side, all
    padded on one side or both, and unequal widths either way."""
    rng = np.random.default_rng(seed)
    if kind == "h1_ne_h2":
        h1, h2 = 17, 5
    elif kind == "h2_gt_h1":
        h1, h2 = 5, 17
    w1, w2, t1, t2 = _random_problems(rng, p=p, h1=h1, h2=h2, m=m)
    if kind == "one_word":
        for w, h in ((w1, h1), (w2, h2)):
            w[:] = 0.0
            w[np.arange(p), rng.integers(0, h, size=p)] = 1.0
    elif kind == "all_padded":
        w1[1] = 0.0          # no valid row
        w2[2] = 0.0          # no valid column
        w1[3] = w2[3] = 0.0  # neither
        w1[4] = 0.0
        w1[4, h1 - 1] = 1.0  # one valid row, at the last slot
    elif kind == "mixed":    # 1 .. h valid words, pair by pair
        for i in range(p):
            n1, n2 = 1 + i * (h1 - 1) // (p - 1), h2 - i * (h2 - 1) // (p - 1)
            w1[i, n1:] = 0.0
            w2[i, n2:] = 0.0
            w1[i, :n1] = w1[i, :n1] + 0.1
            w2[i, :n2] = w2[i, :n2] + 0.1
            w1[i] /= w1[i].sum()
            w2[i] /= w2[i].sum()
    return w1, w2, t1, t2


RAGGED = ["one_word", "all_padded", "h1_ne_h2", "h2_gt_h1", "mixed"]
RAGGED_KW = dict(eps=0.05, eps_scaling=2, max_iters=60)


@pytest.mark.parametrize("kind", RAGGED)
def test_sinkhorn_plain_matches_pallas_on_ragged_pairs(kind):
    w1, w2, t1, t2 = _ragged_problems(kind)
    want = np.asarray(jops.sinkhorn_wmd(
        jnp.asarray(t1), jnp.asarray(w1), jnp.asarray(t2), jnp.asarray(w2),
        interpret=True, **RAGGED_KW))
    got, iters = tsk.sinkhorn_plain(_t(t1), _t(w1), _t(t2), _t(w2), **RAGGED_KW)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    empty = ((w1 > 0).sum(1) == 0) | ((w2 > 0).sum(1) == 0)
    assert np.all(got.numpy()[empty] == 0.0)
    # no valid row: one iteration a level; rows but no column: max_iters
    assert np.all(iters.numpy()[(w1 > 0).sum(1) == 0] == 2)
    no_col = ((w1 > 0).sum(1) > 0) & ((w2 > 0).sum(1) == 0)
    assert np.all(iters.numpy()[no_col] == 2 * RAGGED_KW["max_iters"])


def test_sinkhorn_valid_words_lists_the_kernels_words():
    rng = np.random.default_rng(2)
    w = rng.uniform(-0.2, 1.0, size=(6, 11)).astype(np.float32)
    w[2] = 0.0
    w[3] = np.where(np.arange(11) == 10, 0.5, 0.0)
    idx, cnt = tsk.valid_words(_t(w))
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    for p in range(6):
        want = np.flatnonzero(w[p] > 0)
        assert cnt[p].item() == len(want)
        assert np.array_equal(idx[p, :len(want)].numpy(), want)
        assert sorted(idx[p].tolist()) == list(range(11))  # a permutation


def _kernel_update(x, pot, lw, wt):
    """One potential update as the kernel makes it (csrc/sinkhorn_wmd.cu,
    ``update``): the sum shifted by pot - lw where it stays in [2^-40,
    2^64], else a second, max-shifted sum.  x (rows, n)."""
    if x.shape[1] == 0:
        return pot.clone(), torch.zeros_like(pot)
    s = torch.exp2(x + (pot - lw)[:, None]).sum(1)
    safe = (s >= 2.0 ** -40) & (s <= 2.0 ** 64)
    mx = x.amax(1)
    s2 = torch.exp2(x - mx[:, None]).sum(1)
    new = torch.where(safe, pot - torch.log2(s + 1e-38),
                      lw - (mx + torch.log2(s2 + 1e-38)))
    marginal = torch.where(safe, wt * s, torch.exp2(pot + mx) * s2)
    return new, marginal


def _sinkhorn_kernel_order(t1, w1, t2, w2, *, eps, eps_scaling, eps_start=1.0,
                           max_iters, tol=1e-5, bf16=False):
    """The kernel's algorithm in plain PyTorch, pair by pair: the valid
    words only, base 2 (u = f K, v = g K with K = log2(e) / eps, rescaled
    between levels), two sweeps an iteration (the row sweep gives the last
    iteration's row marginal and the f update), one-sweep shifted sums
    with the max-shifted fallback, the final plan's cost per row as its
    scale times sum(plan * cost)."""
    levels = tsk.eps_schedule(eps, eps_scaling, eps_start)
    ks = [torch.tensor(tsk.LOG2E / e, dtype=torch.float32) for e in levels]
    i1, c1 = tsk.valid_words(w1)
    i2, c2 = tsk.valid_words(w2)
    costs, iters = [], []
    for p in range(t1.shape[0]):
        r, c = i1[p, :c1[p]].long(), i2[p, :c2[p]].long()
        a, b = w1[p, r], w2[p, c]
        x1, x2 = t1[p, r], t2[p, c]
        a2, b2 = (x1 * x1).sum(1), (x2 * x2).sum(1)
        if bf16:
            x1, x2 = tdist.bf16_round(x1), tdist.bf16_round(x2)
        cost = torch.sqrt(torch.clamp(a2[:, None] + b2[None, :] - 2.0 * x1 @ x2.T,
                                      min=0.0))
        la2 = torch.log2(torch.clamp(a, min=1e-38))
        lb2 = torch.log2(torch.clamp(b, min=1e-38))
        masked = w1[p][~(w1[p] > 0)].abs().sum()
        u, v = torch.zeros_like(a), torch.zeros_like(b)
        total = 0
        for li, k in enumerate(ks):
            if li:
                ratio = k / ks[li - 1]
                u, v = u * ratio, v * ratio
            it = 0
            while it < max_iters:
                un, marginal = _kernel_update(v[None, :] - cost * k, u, la2, a)
                if it > 0 and not bool((marginal - a).abs().sum() + masked > tol):
                    break
                u = un
                v, _ = _kernel_update(u[None, :] - cost.T * k, v, lb2,
                                      torch.ones_like(b))
                it += 1
            total += it
        x = u[:, None] + v[None, :] - cost * ks[-1]
        if x.numel():
            pj = torch.exp2(x - x.amax(1, keepdim=True))
            costs.append((a / torch.clamp(pj.sum(1), min=1e-30)
                          * (pj * cost).sum(1)).sum())
        else:
            costs.append(torch.zeros(()))
        iters.append(total)
    return torch.stack(costs), torch.tensor(iters, dtype=torch.int32)


@pytest.mark.parametrize("case", [f"cfg{i}" for i in range(len(CONFIGS))]
                         + RAGGED + ["bf16", "max_iters_0"])
def test_sinkhorn_kernel_order_matches_plain_and_pallas(case):
    """The kernel's merged two-sweep, base-2 iteration with shifted sums
    gives the plain version's costs and iteration counts, and the Pallas
    kernel's costs."""
    bf16 = case == "bf16"
    if case.startswith("cfg"):
        kw = CONFIGS[int(case[3:])]
        w1, w2, t1, t2 = _random_problems(np.random.default_rng(0))
    else:
        kw = dict(RAGGED_KW, max_iters=0) if case == "max_iters_0" else RAGGED_KW
        w1, w2, t1, t2 = (_ragged_problems(case) if case in RAGGED else
                          _random_problems(np.random.default_rng(1), p=6))
    args = tuple(map(_t, (t1, w1, t2, w2)))
    got, it = _sinkhorn_kernel_order(*args, bf16=bf16, **kw)
    want, want_it = tsk.sinkhorn_plain(*args, bf16_matmul=bf16, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
    # Counts agree where the stop does not hinge on float noise: no valid
    # row (one iteration a level), rows but no column (max_iters a level),
    # max_iters = 0.  Where the L1 error hovers near tol the two sum orders
    # may stop a few (at tol 1e-5, a few hundred) iterations apart.
    n1, n2 = (w1 > 0).sum(1), (w2 > 0).sum(1)
    fixed = torch.tensor((n1 == 0) | (n2 == 0)) | (kw["max_iters"] == 0)
    assert torch.equal(it[fixed], want_it[fixed])
    ref = np.asarray(jops.sinkhorn_wmd(
        *map(jnp.asarray, (t1, w1, t2, w2)), bf16_matmul=bf16, interpret=True,
        **kw))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)


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
# B8 flash attention
# ---------------------------------------------------------------------------
def _qkv(rng, b, s, t, hq, hkv, dh):
    return (rng.normal(size=(b, s, hq, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32))


# The cases of the reference's tests/test_kernels.py: GQA, MHA, MQA and
# bidirectional, in 128-row blocks.
FLASH_CASES = [
    (2, 256, 4, 2, 64, True),
    (1, 512, 8, 8, 32, True),    # MHA
    (2, 256, 4, 1, 64, True),    # MQA
    (1, 256, 4, 2, 128, False),  # bidirectional
]


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(b, s, hq, hkv, dh, causal):
    q, k, v = _qkv(np.random.default_rng(s + hq + dh), b, s, s, hq, hkv, dh)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=128, block_k=128,
                                interpret=True)
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               block_q=128, block_k=128)
    # float32 on both sides: only the order of the sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_bf16_matches_pallas(causal):
    q, k, v = _qkv(np.random.default_rng(5), 1, 256, 256, 4, 2, 64)
    bf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = jops.flash_attention(*bf, causal=causal, block_q=128, block_k=128,
                                interpret=True)
    got = tops.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                               causal=causal, block_q=128, block_k=128)
    assert got.dtype == torch.bfloat16
    # p is rounded to bf16 against the running max of a 128-key block in the
    # Pallas kernel and against the row's max here, and both outputs are
    # rounded to bf16: the bars of the CUDA kernel against this version.
    gap = tfa.bf16_gap(got, _t(want.astype(jnp.float32)))
    assert gap["ok"], gap


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_oracles(causal):
    """Lengths that are not tile multiples, T != S, group 3."""
    q, k, v = _qkv(np.random.default_rng(6), 2, 37, 53, 6, 2, 16)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = tfa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    oracle = tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_plain_q_offset_gives_a_slice_of_rows():
    q, k, v = (_t(x) for x in _qkv(np.random.default_rng(7), 1, 96, 96, 4, 2, 32))
    full = tfa.flash_attention_plain(q, k, v)
    part = tfa.flash_attention_plain(q[:, 40:72], k[:, :72], v[:, :72],
                                     q_offset=40)
    torch.testing.assert_close(part, full[:, 40:72], rtol=1e-6, atol=1e-6)


def _kernel_order(q, k, v, causal, skip=None, round_p=True,
                  bk=tfa.KEY_TILE):
    """B8's numerics in the CUDA kernels' order, on the CPU: key tiles of
    the kernels' width in ascending order, the running max, p rounded to
    v's dtype against it (unless ``round_p`` is False), float32 sums,
    O / max(l, 1e-30) cast to q's dtype.  ``skip`` drops one KV tile.  The
    last two are planted faults."""
    b, s, hq, dh = q.shape
    _, t, hkv, _ = k.shape
    qf = q.float().reshape(b, s, hkv, hq // hkv, dh)
    m = torch.full((b, hkv, hq // hkv, s, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, s, dh))
    for k0 in range(0, t, bk):
        if k0 // bk == skip:
            continue
        sc = torch.einsum("bshgd,bthd->bhgst", qf, k[:, k0:k0 + bk].float())
        sc = sc * dh ** -0.5
        if causal:
            cols = torch.arange(k0, min(k0 + bk, t))[None, :]
            sc = sc.masked_fill(cols > torch.arange(s)[:, None], -1e30)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if round_p:
            p = p.to(v.dtype).float()
        acc = acc * alpha + torch.einsum("bhgst,bthd->bhgsd", p,
                                         v[:, k0:k0 + bk].float())
        m = m_new
    o = acc / l.clamp(min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(q.dtype)


@pytest.fixture(scope="module")
def flash_bf16_case():
    """llama3.2-1b's head dim and group, S = T = 4,096, bf16."""
    g = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16)
               for shape in ((1, 4096, 4, 64), (1, 4096, 1, 64), (1, 4096, 1, 64)))
    plain = {c: tfa.flash_attention_plain(q, k, v, causal=c) for c in (True, False)}
    return q, k, v, plain


@pytest.mark.parametrize("skip", [None, 0, 32, 63])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_bars_hold_the_kernel_order_and_fail_a_skipped_tile(
        flash_bf16_case, causal, skip):
    """The bars of B8 (bf16) against its plain version pass the kernel's own
    roundings and fail a kernel that skips any one KV tile."""
    q, k, v, plain = flash_bf16_case
    gap = tfa.bf16_gap(_kernel_order(q, k, v, causal, skip=skip), plain[causal])
    print(f"causal={causal} skip={skip}: {gap}")
    assert gap["ok"] == (skip is None), gap


def test_flash_p_rounding_probe_catches_p_kept_in_float32():
    """The rounding of p to bf16 is below the bars on random inputs; the
    probe shows it: the plain version, the Pallas kernel and the kernel's
    order give its O, and a p kept in float32 gives 1."""
    q, k, v, want = tfa.p_rounding_probe(device="cpu")
    assert torch.equal(tfa.flash_attention_plain(q, k, v, causal=False), want)
    assert torch.equal(_kernel_order(q, k, v, False), want)
    ref = jops.flash_attention(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                                 for x in (q, k, v)),
                               causal=False, block_q=64, block_k=256,
                               interpret=True)
    assert torch.equal(_t(ref.astype(jnp.float32)).to(torch.bfloat16), want)
    fault = _kernel_order(q, k, v, False, round_p=False)
    assert bool((fault == 1.0).all()) and not torch.equal(fault, want)


def test_ops_flash_attention_keeps_the_block_rule():
    q, k, v = (_t(x) for x in _qkv(np.random.default_rng(0), 1, 96, 96, 2, 1, 32))
    with pytest.raises(ValueError, match="block multiple"):
        tops.flash_attention(q, k, v, block_q=64)
    out = tops.flash_attention(q, k, v, block_q=32, block_k=96)
    assert out.shape == q.shape


def test_flash_hbm_bytes_follows_the_port_tiling():
    assert tfa.tiling(64, 4) == (256, 4, 64)      # llama3.2-1b: 4 heads x 64
    assert tfa.tiling(32, 1) == (256, 1, 256)
    assert tfa.tiling(128, 4) == (128, 2, 64)
    assert tfa.tiling(64, 3) == (256, 1, 256)
    # every CTA's positions are whole 32-row warps and whole key tiles
    for dh in tfa.HEAD_DIMS:
        for group in (1, 2, 3, 4, 8):
            r, gc, bq = tfa.tiling(dh, group)
            assert r == gc * bq and group % gc == 0
            assert bq % 32 == 0 and bq % tfa.KEY_TILE == 0
    b, s, hq, hkv, dh = 4, 4096, 32, 8, 64
    qo = 2 * b * s * hq * dh * 2
    # non-causal: every CTA reads all T keys of K and V once for 4 heads
    assert tfa.flash_hbm_bytes(b, s, s, hq, hkv, dh, causal=False) == \
        qo + 2 * b * hkv * (s // 64) * s * dh * 2
    causal = tfa.flash_hbm_bytes(b, s, s, hq, hkv, dh)
    n = s // 64
    assert causal == qo + 2 * b * hkv * 64 * (n * (n + 1) // 2) * dh * 2
    # a ragged KV tail: keys past T are not read
    t = 4000
    assert tfa.flash_hbm_bytes(b, s, t, hq, hkv, dh, causal=False) == \
        qo + 2 * b * hkv * (s // 64) * t * dh * 2


# ---------------------------------------------------------------------------
# B9 segment SpMM (gather-scale-scatter)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,e,d", [(16, 64, 32), (50, 200, 8), (8, 8, 130)])
def test_segment_spmm_plain_matches_pallas(n, e, d):
    rng = np.random.default_rng(n * 1000 + e + d)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)  # CSR order
    feat = rng.normal(size=(n, d)).astype(np.float32)
    rad = rng.uniform(0.1, 1, e).astype(np.float32)
    rad[rng.random(e) < 0.2] = 0.0  # padding edges
    want = jops.segment_spmm(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(feat), jnp.asarray(rad), n,
                             interpret=True)
    got = tops.segment_spmm(_t(src), _t(dst), _t(feat), _t(rad), n)
    assert got.shape == (n, d)
    # both add rad*feat in ascending edge order per row
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tref.segment_spmm_ref(_t(src), _t(dst), _t(feat), _t(rad), n).numpy(),
        np.asarray(jref.segment_spmm_ref(jnp.asarray(src), jnp.asarray(dst),
                                         jnp.asarray(feat), jnp.asarray(rad), n)),
        rtol=1e-5, atol=1e-5)


def test_segment_spmm_zero_degree_rows_and_sink_padding():
    # nodes 3..6 receive no edges; padding edges (rad 0) go to the sink row 7
    src = np.array([0, 1, 2, 4, 5], np.int32)
    dst = np.array([0, 0, 2, 7, 7], np.int32)
    feat = np.ones((8, 16), np.float32)
    rad = np.array([1, 1, 1, 0, 0], np.float32)
    want = np.asarray(jops.segment_spmm(*map(jnp.asarray, (src, dst, feat, rad)),
                                        8, interpret=True))
    got = tops.segment_spmm(*map(_t, (src, dst, feat, rad)), 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].sum() == 32.0 and got[2].sum() == 16.0
    assert (got[[1, 3, 4, 5, 6, 7]] == 0).all()
    off = tseg.row_offsets(_t(dst), 8)
    assert off.dtype == torch.int32
    assert off.tolist() == [0, 2, 2, 3, 3, 3, 3, 3, 5]


def _lower_bound_warp(dst, lo, hi, key):
    """B9's search of the sorted dst on the CPU: each step probes the last
    element of 32 equal buckets (one a lane) and keeps the first bucket
    whose last element reaches ``key``.  Returns (index, steps)."""
    steps = 0
    while hi - lo > 32:
        length = hi - lo
        step = (length + 31) // 32
        k = sum(int(dst[lo + min((lane + 1) * step, length) - 1] < key)
                for lane in range(32))
        nlo = lo + k * step
        hi = min(nlo + step, hi)
        lo = min(nlo, hi)
        steps += 1
    return lo + sum(int(lo + lane < hi and dst[lo + lane] < key)
                    for lane in range(32)), steps


def _segment_kernel_order(src, dst, feat, rad, n_out, rows):
    """B9's walk on the CPU, in float32: a warp owns ``rows`` rows, finds
    its first edge by the search and walks on until an edge's dst reaches
    the next warp's rows, adds each edge's rad * feat row to its row's sum
    in edge order (product and sum rounded apart), stores a row when the
    dst changes and writes 0 to the rows no edge reaches.  The UNROLL rows
    in flight do not change that order.  Returns the output and how many
    times each row was written."""
    f32 = np.float32
    out = np.full((n_out, feat.shape[1]), np.nan, f32)
    writes = np.zeros(n_out, np.int64)

    def store(r, v):
        out[r] = v
        writes[r] += 1

    for r0 in range(0, n_out, rows):
        r1 = min(r0 + rows, n_out)
        e = _lower_bound_warp(dst, 0, len(dst), r0)[0]
        acc, row, nxt = None, -1, r0
        for e in range(e, len(dst)):
            if dst[e] >= r1:
                break
            if dst[e] != row:
                if row >= 0:
                    store(row, acc)
                    nxt = row + 1
                for r in range(nxt, dst[e]):
                    store(r, 0.0)
                row, acc = dst[e], np.zeros(feat.shape[1], f32)
            acc = acc + f32(rad[e]) * feat[src[e]]
        if row >= 0:
            store(row, acc)
            nxt = row + 1
        for r in range(nxt, r1):
            store(r, 0.0)
    return out, writes


@pytest.mark.parametrize("kind", ["runs", "sparse_keys", "empty"])
def test_segment_lower_bound_warp_matches_searchsorted(kind):
    """The kernel's search (the first edge it finds in place of the
    wrapper's row_offsets pass) against np.searchsorted, with keys below, inside,
    between and above the values, and long runs of one value."""
    rng = np.random.default_rng(len(kind))
    if kind == "runs":      # a hub of 5,000 edges among short rows
        dst = np.sort(np.concatenate([rng.integers(0, 400, 3000),
                                      np.full(5000, 123)]))
    elif kind == "sparse_keys":
        dst = np.sort(rng.integers(0, 10**6, 20_000) * 7)
    else:
        dst = np.zeros(0, np.int64)
    keys = np.unique(np.concatenate([
        [-1, 0, 1, 123, 124], rng.integers(-5, int(dst.max(initial=0)) + 5, 200),
        [int(dst.max(initial=0)) + 1]]))
    for key in keys:
        want = int(np.searchsorted(dst, key, side="left"))
        got, steps = _lower_bound_warp(dst, 0, len(dst), int(key))
        assert got == want
        assert steps <= max(1, int(np.ceil(np.log(max(len(dst), 2)) / np.log(32))))
        lo = want // 2   # a search from a known lower end, as for e1
        assert _lower_bound_warp(dst, lo, len(dst), int(key))[0] == want


@pytest.mark.parametrize("rows", [1, 3, 32])
@pytest.mark.parametrize("d", [1, 5])
def test_segment_kernel_order_matches_plain(rows, d):
    """B9's walk writes every row once and equals the plain version bit for
    bit (the CPU adds in edge order): degree-0 rows, a first row with no
    edge, a hub row and the sink row's padding edges."""
    rng = np.random.default_rng(rows * 10 + d)
    n = 97
    alive = rng.random(n - 1) > 0.2
    alive[0] = False
    rows_alive = np.flatnonzero(alive)
    dst = np.sort(np.concatenate([rng.choice(rows_alive, 600),
                                  np.full(300, rows_alive[len(rows_alive) // 2])]))
    dst = np.concatenate([dst, np.full(20, n - 1)]).astype(np.int32)
    src = rng.integers(0, n, len(dst)).astype(np.int32)
    rad = rng.uniform(0.1, 1, len(dst)).astype(np.float32)
    rad[-20:] = 0.0
    feat = rng.normal(size=(n, d)).astype(np.float32)
    got, writes = _segment_kernel_order(src, dst, feat, rad, n, rows)
    assert (writes == 1).all()
    want = tseg.segment_spmm_plain(*map(_t, (src, dst, feat, rad)), n).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[-1].any()


def test_segment_vector_width():
    """16-byte loads only for D % 4 == 0 and 16-byte aligned pointers."""
    assert tseg.vector_width(100, 0, 256) == 4
    assert tseg.vector_width(128) == 4
    for d, ptrs in ((1, ()), (3, ()), (129, ()), (100, (4,)), (100, (0, 8))):
        assert tseg.vector_width(d, *ptrs) == 1


@pytest.mark.parametrize("b", [1, 2, 20, 32, 33, 63, 64, 65, 127, 128, 130, 256,
                               301])
def test_spmm_column_plan_covers_every_column_once(b):
    """The blocked kernel's lanes: each column of B in exactly one lane's
    cw adjacent columns of one chunk of 32 * cw; vector loads only where B
    is a multiple of cw and the pointers are aligned to cw floats."""
    for ptrs in ((0, 256), (4, 0), (8, 16)):
        cw, vec = tsp.column_plan(b, *ptrs)
        assert cw == (1 if b <= 32 else 2 if b <= 64 else 4)
        assert vec == (b % cw == 0 and all(p % (4 * cw) == 0 for p in ptrs))
        cols = [c0 + lane * cw + j for c0 in range(0, b, 32 * cw)
                for lane in range(32) for j in range(cw) if c0 + lane * cw + j < b]
        assert sorted(cols) == list(range(b))
        assert -(-b // (32 * cw)) == (1 if b <= 128 else -(-b // 128))


def _blocked_kernel_order(ids, w, z, slots=64, unroll=8):
    """B2's order on the CPU: per row, the nonzero slots of each 64-slot
    piece listed (the ballot), taken ``unroll`` at a time in slot order,
    each an fmaf into the columns' chains."""
    n, h = ids.shape
    out = np.zeros((n, z.shape[1]), np.float32)
    for i in range(n):
        acc = np.zeros(z.shape[1], np.float32)
        for p0 in range(0, h, slots):
            listed = [p for p in range(p0, min(p0 + slots, h)) if w[i, p] != 0]
            for g in range(0, len(listed), unroll):
                for p in listed[g:g + unroll]:
                    acc = _fma(w[i, p], z[ids[i, p]], acc)
        out[i] = acc
    return out


def test_spmm_blocked_kernel_order_equals_the_full_fmaf_chain():
    """Skipping the zero-weight slots leaves every fmaf chain as it is (Z
    finite), so B2 equals the seed kernel's chain over all slots (B6b) bit
    for bit; both match the Pallas kernel within rounding."""
    rng = np.random.default_rng(23)
    ids, w = _mk_ell(rng, 40, 150, 300, pad=0.6)
    w[::4] = 0.0
    z = rng.normal(size=(300, 7)).astype(np.float32)
    got = _blocked_kernel_order(ids, w, z)
    full = np.zeros_like(got)
    for p in range(ids.shape[1]):
        full = _fma(w[:, p:p + 1], z[ids[:, p]], full)
    np.testing.assert_array_equal(got, full)
    want = np.asarray(jops.spmm_ell(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(z), mode="blocked",
                                    interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsp.spmm_ell_naive_plain(*map(_t, (ids, w, z))),
                               got, rtol=1e-5, atol=1e-5)


def _staged(flat, g0, cnt, base_words, cap):
    """One stage of a block as B6b's producer leaves it in shared memory:
    slot j at buf[shift + j], where shift is the block's start in 4-byte
    words past a 16-byte boundary (the array's base at ``base_words``);
    the body by the bulk copy, the head and tail by ordinary loads.  Every
    other place holds junk."""
    shift = (base_words + g0) % 4
    head = min(cnt, (4 - shift) % 4)
    body = (cnt - head) // 4 * 4
    assert (shift + head) % 4 == 0 or body == 0   # the copy's ends are aligned
    buf = np.full(cap + 4, np.nan if flat.dtype == np.float32 else -7,
                  flat.dtype)
    buf[shift + head:shift + head + body] = flat[g0 + head:g0 + head + body]
    for j in list(range(head)) + list(range(head + body, cnt)):
        assert j < head or j - head - body < 4
        buf[shift + j] = flat[g0 + j]
    return buf, shift


def _naive_kernel_order(ids, w, z, *, rows=None, cap=tsp.NAIVE_CAP,
                        warps=tsp.NAIVE_WARPS, ctas=3, base_words=(0, 0),
                        u=8):
    """B6b's walk on the CPU: CTAs take tiles of ``rows`` rows in a static
    stride, each tile's flat slots in stages of ``cap`` as ``_staged`` leaves
    them; warp ``i % warps`` takes a tile's row i: its slots in the stage,
    64 at a time, the nonzero ones listed and added ``u`` at a time, each an
    fmaf in slot order from +0; a row that goes on into the next stage
    carries its partial sums in its D row."""
    n, h = ids.shape
    rows = rows or tsp.naive_tile_rows(h)
    fi, fw = ids.reshape(-1), w.reshape(-1)
    out = np.full((n, z.shape[1]), np.nan, np.float32)
    n_tiles = -(-n // rows)
    for cta in range(ctas):
        for t in range(cta, n_tiles, ctas):
            gs, ge = t * rows * h, min(n, (t + 1) * rows) * h
            for g0 in range(gs, ge, cap):
                cnt = min(cap, ge - g0)
                si, shi = _staged(fi, g0, cnt, base_words[0], cap)
                sw, shw = _staged(fw, g0, cnt, base_words[1], cap)
                l0, l1 = g0 - gs, g0 - gs + cnt
                i0, i1 = l0 // h, (l1 - 1) // h
                for warp in range(warps):
                    for i in range(i0 + (warp - i0) % warps, i1 + 1, warps):
                        rs = i * h
                        k0, k1 = max(0, l0 - rs), min(h, l1 - rs)
                        at = rs + k0 - l0
                        row = t * rows + i
                        acc = (np.zeros(z.shape[1], np.float32) if k0 == 0
                               else out[row].copy())
                        for p0 in range(0, k1 - k0, 64):
                            listed = [(si[shi + at + p], sw[shw + at + p])
                                      for p in range(p0, min(p0 + 64, k1 - k0))
                                      if sw[shw + at + p] != 0]
                            for g in range(0, len(listed), u):
                                for i_d, wv in listed[g:g + u]:
                                    acc = _fma(wv, z[i_d], acc)
                        out[row] = acc
    return out


def _slot_order(ids, w, z):
    """The fmaf chain over every slot in order from +0 (the seed's sum)."""
    full = np.zeros((ids.shape[0], z.shape[1]), np.float32)
    for p in range(ids.shape[1]):
        full = _fma(w[:, p:p + 1], z[ids[:, p]], full)
    return full


def _naive_case(h, b, seed):
    """An ELL set of n rows (not a multiple of the tile's), a third of its
    slots zero-weight, all-zero rows, ids 0 and v - 1 in use."""
    rng = np.random.default_rng(seed)
    rows = tsp.naive_tile_rows(h)
    n, v = rows + rows // 2 + 3, 97
    ids, w = _mk_ell(rng, n, h, v, pad=0.35)
    ids[::4, 0], ids[1::4, -1] = 0, v - 1
    w[::5] = 0.0
    z = rng.normal(size=(v, b)).astype(np.float32)
    return ids, w, z


@pytest.mark.parametrize("b", [1, 3, 64, 65, 130])
@pytest.mark.parametrize("h", [1, 3, 48, 160, 300])
def test_spmm_naive_kernel_order_matches_slot_order_and_pallas(h, b):
    """B6b's walk with the kernel's tiles and stages (at h = 160 and 300 a
    tile of 8 rows takes two and three stages, rows split between them),
    both arrays' bases misaligned: bit-equal to the slot-order fmaf chain
    over every slot, all-zero rows +0; within 1e-5 of the Pallas seed
    kernel."""
    ids, w, z = _naive_case(h, b, seed=h * 1000 + b)
    got = _naive_kernel_order(ids, w, z, base_words=(1, 3))
    np.testing.assert_array_equal(got, _slot_order(ids, w, z))
    assert not got[::5].any() and not np.signbit(got[::5]).any()
    want = np.asarray(jops.spmm_ell(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(z), mode="naive",
                                    interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cap,warps,rows,h", [
    (16, 2, 2, 13),     # rows of 13 slots over stages of 16: most split
    (64, 4, 4, 150),    # a row spans three stages, pieces of 64 inside
    (12, 2, 2, 3),      # a stage of whole rows, the tile's last one short
    (tsp.NAIVE_CAP, tsp.NAIVE_WARPS, tsp.NAIVE_WARPS, 700),  # the kernel's own
])
@pytest.mark.parametrize("base_words", [(0, 0), (2, 1), (3, 3)])
def test_spmm_naive_kernel_order_any_stage_split(cap, warps, rows, h,
                                                 base_words):
    """The walk at stages that cut rows anywhere, misaligned heads and
    tails on both arrays: still the slot-order chain bit for bit."""
    rng = np.random.default_rng(cap + h + sum(base_words))
    ids, w = _mk_ell(rng, 2 * rows * 3 + 1, h, 50, pad=0.4)
    w[1::3] = 0.0
    z = rng.normal(size=(50, 5)).astype(np.float32)
    got = _naive_kernel_order(ids, w, z, rows=rows, cap=cap, warps=warps,
                              ctas=2, base_words=base_words)
    np.testing.assert_array_equal(got, _slot_order(ids, w, z))


@pytest.mark.parametrize("h", [1, 3, 4, 47, 48, 64, 160, 255, 256, 257, 300,
                               2048, 5000])
def test_spmm_naive_tile_rows(h):
    """Tiles of whole warps' worth of rows (so a multiple of 4: one
    contiguous block a tile, aligned when the base is), filling at most a
    stage unless a warp's share of a stage is narrower than a row."""
    rows = tsp.naive_tile_rows(h)
    assert rows % tsp.NAIVE_WARPS == 0 and rows % 4 == 0
    assert tsp.NAIVE_WARPS <= rows <= tsp.NAIVE_MAX_ROWS
    assert rows * h <= tsp.NAIVE_CAP or rows == tsp.NAIVE_WARPS
    if rows < tsp.NAIVE_MAX_ROWS:
        assert (rows + tsp.NAIVE_WARPS) * h > tsp.NAIVE_CAP


def _naive_probe():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "naive_probe.py"
    spec = importlib.util.spec_from_file_location("naive_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["one_row", "general", "id_keys", "warps12",
                                  "warps16", "cap2048", "stages3", "u4"])
def test_naive_probe_variants_apply_to_the_source(name):
    """Each variant ``tools/naive_probe.py`` times changes the kernel source
    where it means to (every substitution matches once), and its tile rows
    are ones the launcher takes; the tree's constants give the wrapper's."""
    probe = _naive_probe()
    subs, warps, cap = probe.VARIANTS[name]
    src = (_build.CSRC / "spmm_ell.cu").read_text()
    for old, _ in subs:
        assert src.count(old) == 1
    for h in (1, 3, 48, 160, 300, 2048):
        rows = probe.tile_rows(h, warps, cap)
        assert rows % warps == 0 and (rows * h <= cap or rows == warps)
        assert probe.tile_rows(h, tsp.NAIVE_WARPS, tsp.NAIVE_CAP) == \
            tsp.naive_tile_rows(h)


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
    for mode in ("dense", "naive"):
        tops.spmm_ell(_t(r_ids), _t(r_w), torch.zeros(96, 2), mode=mode)
    tops.lc_rwmd_fused(*map(_t, (emb, q_ids, q_w, r_ids, r_w)), vocab_chunk=32,
                       fuse="kernel")
    tops.rwmd_pairwise(*map(_t, (emb, r_ids, r_w, q_ids, q_w)))
    q, k, v = (_t(x) for x in _qkv(np.random.default_rng(1), 1, 8, 8, 2, 1, 32))
    tops.flash_attention(q, k, v)
    src, dst = torch.tensor([0, 1], dtype=torch.int32), torch.tensor([0, 0], dtype=torch.int32)
    tops.segment_spmm(src, dst, torch.ones(2, 3), torch.ones(2), 2)
    assert sum(_build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tseg.segment_spmm_cuda(src, dst, torch.ones(2, 3), torch.ones(2), 2)
    for fn in (tsp.spmm_ell_cuda, tsp.spmm_ell_dense_cuda,
               tsp.spmm_ell_naive_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(_t(r_ids), _t(r_w), torch.zeros(96, 2))
    with pytest.raises(ValueError, match="CUDA"):
        trw.rwmd_pairwise_cuda(*map(_t, (emb, r_ids, r_w, q_ids, q_w)))
    with pytest.raises(ValueError, match="CUDA"):
        tfs.fused_chunk_cuda(_t(emb[:32]), _t(emb[q_ids]), _t(q_w > 0).float(),
                             _t(r_ids), _t(r_w), 0, torch.zeros(40, 5))


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
    for name, fns in _build.QUERIES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn in fns:
            assert f'extern "C" int {fn}(' in src
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")
