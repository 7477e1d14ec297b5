"""Drive the PyTorch/CUDA port on one GPU and check it: the query cascade and
the paper's comparison path (streaming LC-RWMD, the SpMM formulations, the
quadratic RWMD and the WMD baselines).

    python3 chip_smoke.py              # Table IV set 2 at scale 0.25: 700,000 docs
    python3 chip_smoke.py --scale 0.01 # a quick rehearsal at 28,000 docs

Phases, each of which exits non-zero on failure:

1. build: the CUDA kernels of ``src/repro_torch/csrc`` are compiled for
   sm_90a (one nvcc per source, in parallel); the build time is printed.
2. small: a small corpus through the engine on the card and on the CPU
   (plain versions): one-sided, dense symmetric, both streaming top-ks,
   the rerank and the pruned cascade must agree.
3. kernels: on the slice's corpus, each kernel at the shapes the main path
   gives it against its plain PyTorch version on the card, with the stated
   tolerance; its time beside the plain version's, the library yardstick's
   where one PyTorch call computes the same function, and its bound on an
   H100 SXM.
4. slice: the synthetic corpus at the paper's Table IV set 2 statistics
   (h_max 48, mean h 27.5, m 300) resident in one engine; a batch of 64
   resident docs goes through the README quickstart (one-sided streaming
   top-32, Sinkhorn rerank to top-5, every query's top-1 is itself),
   ``one_sided`` and ``pruned_wmd_topk``.  The kernel launch counts are
   reset just before and read just after; each kernel must have run.
   Then per-call times after warm-up and the peak device memory.
5. comparison: the paper's comparison path on the same corpus, with the
   counts reset just before and read just after: phase 2 by each SpMM
   formulation (blocked, dense, naive) on the engine's Z, the vocab-streamed
   one-sided LC-RWMD (``fuse="kernel"`` and ``"scan"``, vocab chunk 512), the
   quadratic RWMD over all docs, and the WMD baselines on the cascade's
   2,048 (candidate, query) pairs.  Then each new kernel against its plain
   version, the streaming results against ``one_sided``, the quadratic RWMD
   against ``core/rwmd.py`` on the first 65,536 docs and against its plain
   version at 160 words a doc (Table IV set 1's h_max), the batched Sinkhorn
   and ``wmd_one_vs_many`` against the Sinkhorn-WMD kernel (at settings
   where they converge), and the kernel's gap to the exact EMD on 16 pairs;
   one line compares the quadratic RWMD's time with LC-RWMD's.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository beside this script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time
import warnings


ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s
# outside the tensor cores; the kernels run IEEE float32 on the FMA units.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KW_RERANK = dict(eps=0.05, eps_scaling=2, max_iters=100)
B = 64           # query batch: resident docs 0..63
K_CAND = 32      # quickstart candidates
K_FINAL = 5
SYM_ROW_BLOCK = 4096  # slab of the symmetric fold; the result does not depend on it
VOCAB_CHUNK = 512     # the streaming engine's chunk (the reference's default)
CHECK_ROWS = 65536    # rows held against the plain versions that gather (n, h, B)
RWMD_QUERY_CHUNK = 4  # queries per GEMM block of core/rwmd.py's check
N_LP = 16             # pairs solved exactly by the LP
SET1_H, SET1_DOCS, SET1_QUERIES = 160, 1024, 16  # B7 at Table IV set 1's h_max
# The WMD solvers are held to each other on the pairs where both stopped on
# tol at every level (total iterations < max_iters): at the rerank's
# settings (eps 0.05 against costs of ~30) most pairs stop at max_iters,
# and unconverged iterates of the log-domain kernel and the batched
# exp-domain solver (whose kernel matrix underflows between absorptions)
# part ways.  At these settings most pairs converge.
WMD_CHECK_KW = dict(eps=0.5, eps_scaling=3, max_iters=2000)
WMD_CONVERGED_MIN_SHARE = 0.5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Mean device milliseconds per call, by CUDA events, after one warm-up
    (``warm=False`` for a call too long to repeat, whose inputs and library
    handles an earlier call already brought up)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds per call ending in a synchronize, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_of(ids, w, n_cols):
    """cuSPARSE yardstick: the resident ELL set as a CSR (n, n_cols) tensor."""
    import torch

    mask = w > 0
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand_as(ids)
    r = rows[mask]
    c = ids[mask].long()
    order = torch.argsort(r * n_cols + c)
    crow = torch.zeros(ids.shape[0] + 1, dtype=torch.int64, device=ids.device)
    crow[1:] = torch.cumsum(mask.sum(dim=1), dim=0)
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, c[order], w[mask][order],
                                       size=(ids.shape[0], n_cols))


def check_topk(name, vals, idx, ref_vals, ref_idx, tol):
    """Values within tol; indices equal wherever both neighbour gaps > tol.

    ``ref_*`` carry one more column than ``vals``, so the last kept slot's
    gap to the first dropped candidate is known.
    """
    import torch

    k = vals.shape[1]
    err = (vals - ref_vals[:, :k]).abs().max().item()
    if not err <= tol:
        fail(f"{name}: values differ by {err} > {tol}")
    gaps = ref_vals[:, 1:] - ref_vals[:, :-1]                    # (B, k)
    big = torch.ones_like(ref_vals[:, :k], dtype=torch.bool)
    big[:, 1:] &= gaps[:, :k - 1] > tol
    big &= gaps[:, :k] > tol
    bad = (idx != ref_idx[:, :k]) & big
    if bad.any():
        fail(f"{name}: {int(bad.sum())} indices differ where the gap exceeds {tol}")
    return err


def kernel_phase(engine, q, report):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels import lc_rwmd_phase1 as p1
    from repro_torch.kernels import sinkhorn_wmd as sk
    from repro_torch.kernels import spmm_ell as sp

    emb_r = engine.emb_restricted
    v_e, m = emb_r.shape
    t = engine.gather_queries(q.ids)                               # (B, h, m)
    valid = (q.weights > 0).to(torch.float32)
    r_ids = engine.resident_restricted.ids
    r_w = engine.resident_restricted.weights
    n, h1 = r_ids.shape
    h2 = t.shape[1]

    # --- B1: phase 1, compared in squared space ---
    z_k = p1.phase1_sq_cuda(emb_r, t, valid)
    z_p = p1.phase1_sq_plain(emb_r, t, valid)
    e2 = (emb_r * emb_r).sum(1)[:, None]
    t2max = ((t * t).sum(2) * valid).amax(1)[None, :]
    tol = 1e-5 * (e2 + t2max)
    diff = (z_k - z_p).abs()
    if not bool((diff <= tol).all()):
        fail(f"lc_rwmd_phase1: |dZ^2| exceeds 1e-5*(|e|^2+|t|^2) at "
             f"{int((diff > tol).sum())} entries (max {diff.max().item()})")
    n_valid = int(valid.sum().item())
    tf = t.reshape(-1, m)
    vmask = valid.reshape(-1) > 0

    def lib_p1():
        d = torch.cdist(emb_r, tf)
        d.masked_fill_(~vmask[None, :], float("inf"))
        return d.reshape(v_e, B, h2).amin(dim=2)

    bnd, by = bound_ms(4 * (v_e * m + B * h2 * m + B * h2 + v_e * B),
                       2.0 * v_e * m * n_valid)
    report["lc_rwmd_phase1"] = dict(
        max_abs_err=diff.max().item(), tol="1e-5*(|e|^2+|t|^2), squared Z",
        ms=time_ms(lambda: p1.phase1_sq_cuda(emb_r, t, valid)),
        plain_ms=time_ms(lambda: p1.phase1_sq_plain(emb_r, t, valid), 2),
        library_ms=time_ms(lib_p1, 2), bound_ms=bnd, bound_by=by)
    del z_p, diff, tol
    log(f"kernel lc_rwmd_phase1: max |dZ^2| "
        f"{report['lc_rwmd_phase1']['max_abs_err']:.3e} within 1e-5*(|e|^2+|t|^2)")

    # --- B2: ELL SpMM ---
    z1 = torch.sqrt(torch.clamp(z_k, min=0.0))
    d_k = sp.spmm_ell_cuda(r_ids, r_w, z1)
    d_p = sp.spmm_ell_plain(r_ids, r_w, z1)
    err = (d_k - d_p).abs()
    if not bool((err <= 1e-5 + 1e-5 * d_p.abs()).all()):
        fail(f"spmm_ell: |dD| exceeds 1e-5 + 1e-5*|D| (max {err.max().item()})")
    csr = csr_of(r_ids, r_w, v_e)
    nnz = csr.values().numel()
    bnd, by = bound_ms(n * h1 * 8 + v_e * B * 4 + n * B * 4, 2.0 * nnz * B)
    report["spmm_ell"] = dict(
        max_abs_err=err.max().item(), tol="1e-5 + 1e-5*|D|",
        ms=time_ms(lambda: sp.spmm_ell_cuda(r_ids, r_w, z1)),
        plain_ms=time_ms(lambda: sp.spmm_ell_plain(r_ids, r_w, z1), 2),
        library_ms=time_ms(lambda: torch.sparse.mm(csr, z1)),
        bound_ms=bnd, bound_by=by)
    log(f"kernel spmm_ell: max |dD| {report['spmm_ell']['max_abs_err']:.3e} "
        f"within 1e-5 + 1e-5*|D|")
    del d_k, d_p, err

    # --- B3: phase 2 folded into the streaming top-k ---
    kk = K_CAND
    v_k, i_k = fs.phase2_topk_cuda(r_ids, r_w, z1, kk)
    v_p, i_p = fs.phase2_topk_plain(r_ids, r_w, z1, kk + 1, row_block=65536)
    tol3 = 1e-4
    err3 = check_topk("fused_topk", v_k, i_k, v_p, i_p, tol3)

    def lib_topk():
        d = torch.sparse.mm(csr, z1)
        return torch.topk(d, kk, dim=0, largest=False)

    bnd, by = bound_ms(n * h1 * 8 + v_e * B * 4 + B * kk * 8, 2.0 * nnz * B)
    report["fused_topk"] = dict(
        max_abs_err=err3, tol=f"values {tol3}; ids where gaps > {tol3}",
        ms=time_ms(lambda: fs.phase2_topk_cuda(r_ids, r_w, z1, kk)),
        plain_ms=time_ms(lambda: fs.phase2_topk_plain(
            r_ids, r_w, z1, kk, row_block=65536), 2),
        library_ms=time_ms(lib_topk), bound_ms=bnd, bound_by=by)
    log(f"kernel fused_topk: max |dval| {err3:.3e} within {tol3}; ids equal "
        f"where the gaps exceed {tol3}")
    del csr

    # --- B4: Sinkhorn-WMD on the rerank's pairs ---
    flat = i_k.reshape(-1).long()
    t1 = engine._t_r.reshape(n, h1, m).index_select(0, flat)
    w1 = engine.resident.weights.index_select(0, flat)
    t2 = t.repeat_interleave(kk, dim=0)
    w2 = q.weights.repeat_interleave(kk, dim=0)
    c_k, it_k = sk.sinkhorn_cuda(t1, w1, t2, w2, **KW_RERANK)
    c_p, it_p = sk.sinkhorn_plain(t1, w1, t2, w2, **KW_RERANK)
    err4 = (c_k - c_p).abs()
    # The cost tile's gram form carries ~sqrt(eps_f32 * (|a|^2 + |b|^2)) of
    # cancellation noise at near-zero costs (a doc against itself), in both
    # versions; that is the absolute floor, 1e-4 the relative part.
    norm2 = float((t1 * t1).sum(2).amax() + (t2 * t2).sum(2).amax())
    atol4 = math.sqrt(2.0 ** -23 * norm2)
    tol4 = atol4 + 1e-4 * c_p.abs()
    worst = int(torch.argmax(err4 - tol4))
    log(f"sinkhorn_wmd: worst pair {worst}: kernel {c_k[worst].item():.6f} "
        f"plain {c_p[worst].item():.6f} iterations {int(it_k[worst])}/"
        f"{int(it_p[worst])}; max rel err where WMD > 1: "
        f"{float((err4 / c_p.abs())[c_p.abs() > 1].max()):.2e}")
    if not bool((err4 <= tol4).all()):
        fail(f"sinkhorn_wmd: |dWMD| exceeds {atol4:.3e} + 1e-4*|WMD| (max "
             f"{err4.max().item()})")
    n1 = (w1 > 0).sum(1).to(torch.float64)
    n2 = (w2 > 0).sum(1).to(torch.float64)
    # Cost tile over the valid words, then per iteration three passes of
    # ~4 operations (one exp) per valid entry.
    ops4 = float((n1 * n2 * (2.0 * m + 12.0 * it_k.to(torch.float64))).sum())
    bnd, by = bound_ms(4 * (t1.numel() + t2.numel() + w1.numel() + w2.numel()
                            + c_k.numel()), ops4)
    report["sinkhorn_wmd"] = dict(
        max_abs_err=err4.max().item(),
        tol=f"{atol4:.3e} (gram floor) + 1e-4*|WMD|",
        ms=time_ms(lambda: sk.sinkhorn_cuda(t1, w1, t2, w2, **KW_RERANK)),
        plain_ms=time_ms(lambda: sk.sinkhorn_plain(t1, w1, t2, w2, **KW_RERANK), 1),
        library_ms=None, bound_ms=bnd, bound_by=by,
        iters_mean=float(it_k.float().mean()),
        iters_equal_share=float((it_k == it_p).float().mean()))
    log(f"kernel sinkhorn_wmd: max |dWMD| {err4.max().item():.3e} within "
        f"{atol4:.3e} + 1e-4*|WMD| (mean iterations "
        f"{report['sinkhorn_wmd']['iters_mean']:.1f})")


def comparison_phase(engine, q, cand, report):
    """The paper's comparison path on the slice's corpus, then its checks.

    The launch counts are reset just before the path and read just after;
    every kernel of the path must have run.  Returns the comparison line's
    numbers.
    """
    import torch

    from repro_torch.core import rwmd as trw
    from repro_torch.core import wmd as twmd
    from repro_torch.core.distances import dists, pair_dists
    from repro_torch.core.lc_rwmd import lc_rwmd_streaming
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import fused_stream as fs
    from repro_torch.kernels import rwmd_pairwise as rw
    from repro_torch.kernels import sinkhorn_wmd as sk
    from repro_torch.kernels import spmm_ell as sp

    docs, emb = engine.resident, engine.emb_full   # on the card, f32
    dev = emb.device
    n, h1 = docs.ids.shape
    v, m = emb.shape
    b, h2 = q.ids.shape
    r_ids = engine.resident_restricted.ids
    r_w = engine.resident_restricted.weights
    v_e = engine.emb_restricted.shape[0]
    t_q = engine.gather_queries(q.ids)                            # (B, h2, m)
    valid = (q.weights > 0).to(torch.float32)
    n_valid_q = int(valid.sum().item())
    # the cascade's (candidate, query) pairs, query-major
    flat = cand.indices.reshape(-1).long()
    ids1 = docs.ids.index_select(0, flat)
    w1 = docs.weights.index_select(0, flat)
    t1 = engine._t_r.reshape(n, h1, m).index_select(0, flat)
    ids2 = q.ids.repeat_interleave(K_CAND, dim=0)
    w2 = q.weights.repeat_interleave(K_CAND, dim=0)
    t2 = t_q.repeat_interleave(K_CAND, dim=0)

    # --- the path, counts reset just before and read just after ---
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launches()
    z1 = engine._phase1(t_q.reshape(b * h2, m), q.weights)        # (v_e, B)
    d_sp = {mode: ops.spmm_ell(r_ids, r_w, z1, mode=mode)
            for mode in ("blocked", "dense", "naive")}
    d_kernel = lc_rwmd_streaming(docs, q, emb, vocab_chunk=VOCAB_CHUNK,
                                 fuse="kernel")
    d_scan = lc_rwmd_streaming(docs, q, emb, vocab_chunk=VOCAB_CHUNK,
                               fuse="scan")
    d_quad = ops.rwmd_pairwise(emb, docs.ids, docs.weights, q.ids, q.weights)
    wmd_k = twmd.wmd_batched_dispatch(t1, w1, t2, w2, use_kernel=True,
                                      **KW_RERANK)
    wmd_b = twmd.wmd_batched(ids1, w1, ids2, w2, emb, **KW_RERANK)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"comparison path launches: {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name in ("lc_rwmd_phase1", "spmm_ell", "spmm_ell_dense",
                 "spmm_ell_naive", "fused_chunk", "rwmd_pairwise",
                 "sinkhorn_wmd"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the comparison path")

    t_phase = time.perf_counter()
    rows = min(CHECK_ROWS, n)
    # Distances near zero (a query's own words) carry the gram form's
    # cancellation noise, ~sqrt(eps_f32 * (|e|^2 + |t|^2)), computed in
    # another order by each kernel and plain version: the absolute floor of
    # the checks that compare two ways of computing them.
    emax2 = float((emb * emb).sum(1).max())
    gram_atol = math.sqrt(2.0 ** -23 * 2.0 * emax2)
    csr = csr_of(r_ids, r_w, v_e)
    nnz = csr.values().numel()

    # --- B6a, B6b: against their plain versions and the blocked kernel ---
    for name, mode, plain, cuda in (
            ("spmm_ell_dense", "dense", sp.spmm_ell_dense_plain,
             sp.spmm_ell_dense_cuda),
            ("spmm_ell_naive", "naive", sp.spmm_ell_naive_plain,
             sp.spmm_ell_naive_cuda)):
        want = plain(r_ids[:rows], r_w[:rows], z1)
        err = (d_sp[mode][:rows] - want).abs()
        if not bool((err <= 1e-5 + 1e-5 * want.abs()).all()):
            fail(f"{name}: |dD| exceeds 1e-5 + 1e-5*|D| on the first {rows} "
                 f"rows (max {err.max().item()})")
        bnd, by = bound_ms(n * h1 * 8 + v_e * b * 4 + n * b * 4, 2.0 * nnz * b)
        report[name] = dict(
            max_abs_err=err.max().item(),
            tol=f"1e-5 + 1e-5*|D| (first {rows} rows)",
            ms=time_ms(lambda: cuda(r_ids, r_w, z1)),
            plain_ms=time_ms(lambda: plain(r_ids, r_w, z1), 1, warm=False),
            library_ms=time_ms(lambda: torch.sparse.mm(csr, z1)),
            bound_ms=bnd, bound_by=by, launches=launches.get(name, 0))
        del want, err
        log(f"kernel {name}: max |dD| {report[name]['max_abs_err']:.3e} within "
            f"1e-5 + 1e-5*|D| on the first {rows} rows")
    blocked = d_sp["blocked"]
    e_nb = (d_sp["naive"] - blocked).abs().max().item()
    if not e_nb <= 1e-6:
        fail(f"spmm_ell_naive: differs from the blocked kernel by {e_nb} > 1e-6")
    e_db = (d_sp["dense"] - blocked).abs()
    if not bool((e_db <= 1e-5 + 1e-5 * blocked.abs()).all()):
        fail(f"spmm_ell_dense: differs from the blocked kernel by "
             f"{e_db.max().item()} > 1e-5 + 1e-5*|D|")
    log(f"all {n} rows: naive vs blocked max |dD| {e_nb:.3e} (<= 1e-6), dense "
        f"vs blocked {e_db.max().item():.3e} (<= 1e-5 + 1e-5*|D|)")
    del csr, d_sp, e_db

    # --- streaming LC-RWMD against one_sided; B5 against its plain version ---
    d1 = engine.one_sided(q)
    for name, d in (("kernel", d_kernel), ("scan", d_scan)):
        if tuple(d.shape) != (n, b) or not bool(torch.isfinite(d).all()):
            fail(f"lc_rwmd_streaming(fuse={name!r}): bad shape or non-finite")
        if not torch.allclose(d, d1, rtol=1e-4, atol=gram_atol):
            fail(f"lc_rwmd_streaming(fuse={name!r}) differs from one_sided by "
                 f"{(d - d1).abs().max().item()} (rtol 1e-4, atol "
                 f"{gram_atol:.3e})")
    log(f"lc_rwmd_streaming: kernel and scan within rtol 1e-4, atol "
        f"{gram_atol:.3e} (gram floor) of one_sided over all {n} rows (max |dD| "
        f"{(d_kernel - d1).abs().max().item():.3e} / "
        f"{(d_scan - d1).abs().max().item():.3e})")
    del d_kernel, d_scan, d1
    vc = VOCAB_CHUNK
    e_c = emb[:vc].contiguous()                                   # chunk 0
    r_ids0, r_w0 = docs.ids, docs.weights
    w_m = r_w0 * (r_ids0 < vc)
    d_k = fs.fused_chunk_cuda(e_c, t_q, valid, r_ids0, r_w0, 0,
                              torch.zeros(n, b, device=dev))
    d_p = fs.fused_chunk_plain(e_c, t_q, valid, r_ids0[:rows], r_w0[:rows], 0,
                               torch.zeros(rows, b, device=dev))
    err5 = (d_k[:rows] - d_p).abs()
    if not bool((err5 <= gram_atol + 1e-4 * d_p.abs()).all()):
        fail(f"fused_chunk: |dD| exceeds {gram_atol:.3e} + 1e-4*|D| on the "
             f"first {rows} rows (max {err5.max().item()})")
    hit_rows = int((w_m > 0).any(dim=1).sum().item())
    nnz_c = int((w_m > 0).sum().item())
    bnd, by = bound_ms(4 * (vc * m + b * h2 * m + b * h2) + n * h1 * 8
                       + hit_rows * b * 8,
                       2.0 * vc * m * n_valid_q + 2.0 * nnz_c * b)
    scratch = torch.zeros(n, b, device=dev)
    report["fused_chunk"] = dict(
        max_abs_err=err5.max().item(),
        tol=f"{gram_atol:.3e} (gram floor) + 1e-4*|D| (chunk 0, first "
            f"{rows} rows)",
        ms=time_ms(lambda: fs.fused_chunk_cuda(e_c, t_q, valid, r_ids0, r_w0,
                                               0, scratch)),
        plain_ms=time_ms(lambda: fs.fused_chunk_plain(
            e_c, t_q, valid, r_ids0, r_w0, 0, scratch), 1),
        library_ms=None, bound_ms=bnd, bound_by=by,
        launches=launches.get("fused_chunk", 0),
        chunk0_rows_hit=hit_rows, chunk0_nnz=nnz_c)
    log(f"kernel fused_chunk: max |dD| {err5.max().item():.3e} within "
        f"{gram_atol:.3e} + 1e-4*|D| (chunk 0: {nnz_c} slots in {hit_rows} "
        f"rows)")
    del d_k, d_p, err5, scratch, w_m

    # --- B7: the quadratic RWMD ---
    if tuple(d_quad.shape) != (n, b) or not bool(torch.isfinite(d_quad).all()):
        fail("rwmd_pairwise: bad shape or non-finite values")
    head = docs[:rows]
    want7 = rw.rwmd_pairwise_plain(emb, head.ids, head.weights, q.ids,
                                   q.weights)
    err7 = (d_quad[:rows] - want7).abs()
    if not bool((err7 <= gram_atol + 1e-4 * want7.abs()).all()):
        fail(f"rwmd_pairwise: |dRWMD| exceeds {gram_atol:.3e} + 1e-4*|RWMD| on "
             f"the first {rows} docs (max {err7.max().item()})")
    core7 = trw.rwmd_many_vs_many(head, q, emb, query_chunk=RWMD_QUERY_CHUNK)
    if not torch.allclose(d_quad[:rows], core7, rtol=1e-4, atol=gram_atol):
        fail(f"rwmd_pairwise differs from core/rwmd.rwmd_many_vs_many by "
             f"{(d_quad[:rows] - core7).abs().max().item()} (rtol 1e-4, "
             f"atol {gram_atol:.3e})")
    if not bool((d_quad >= d_quad.new_zeros(())).all()):
        fail("rwmd_pairwise: negative distances")
    n1 = float((docs.weights > 0).sum().item())
    bnd, by = bound_ms(4 * v * m + n * h1 * 8 + b * h2 * 8 + n * b * 4,
                       2.0 * m * n1 * n_valid_q)
    report["rwmd_pairwise"] = dict(
        max_abs_err=err7.max().item(),
        tol=f"{gram_atol:.3e} (gram floor) + 1e-4*|RWMD| (first {rows} docs)",
        ms=time_ms(lambda: rw.rwmd_pairwise_cuda(
            emb, docs.ids, docs.weights, q.ids, q.weights), 1, warm=False),
        plain_ms=time_ms(lambda: rw.rwmd_pairwise_plain(
            emb, docs.ids, docs.weights, q.ids, q.weights), 1, warm=False),
        library_ms=None, bound_ms=bnd, bound_by=by,
        launches=launches.get("rwmd_pairwise", 0))
    log(f"kernel rwmd_pairwise: max |dRWMD| {err7.max().item():.3e} within "
        f"{gram_atol:.3e} + 1e-4*|RWMD| of its plain version; max "
        f"{(d_quad[:rows] - core7).abs().max().item():.3e} from "
        f"rwmd_many_vs_many on the first {rows} docs")
    del want7, err7, core7, head
    # Docs and queries of Table IV set 1's h_max (160 words, more than one
    # 128-row tile of the kernel) on the same vocabulary.
    g1 = torch.Generator(device=dev).manual_seed(1)
    ids160 = torch.randint(0, v, (SET1_DOCS + SET1_QUERIES, SET1_H), device=dev,
                           generator=g1, dtype=torch.int32)
    w160 = torch.rand(ids160.shape, device=dev, generator=g1)
    w160 = w160 * (torch.rand(ids160.shape, device=dev, generator=g1) > 0.2)
    w160 = w160 / w160.sum(1, keepdim=True)
    args160 = (emb, ids160[:SET1_DOCS], w160[:SET1_DOCS],
               ids160[SET1_DOCS:], w160[SET1_DOCS:])
    got160 = rw.rwmd_pairwise_cuda(*args160)
    want160 = rw.rwmd_pairwise_plain(*args160)
    err160 = (got160 - want160).abs()
    if not bool((err160 <= gram_atol + 1e-4 * want160.abs()).all()):
        fail(f"rwmd_pairwise at h = {SET1_H}: |dRWMD| exceeds {gram_atol:.3e} "
             f"+ 1e-4*|RWMD| (max {err160.max().item()})")
    log(f"kernel rwmd_pairwise at h = {SET1_H} ({SET1_DOCS} docs x "
        f"{SET1_QUERIES} queries): max |dRWMD| {err160.max().item():.3e} "
        f"within {gram_atol:.3e} + 1e-4*|RWMD| of its plain version")
    del ids160, w160, args160, got160, want160, err160

    # --- WMD baselines on the cascade's pairs ---
    norm2 = float((t1 * t1).sum(2).amax() + (t2 * t2).sum(2).amax())
    atol4 = math.sqrt(2.0 ** -23 * norm2)
    e_rerank = (wmd_b - wmd_k).abs().max().item()   # reported, see WMD_CHECK_KW
    chk_k, it_k = sk.sinkhorn(t1, w1, t2, w2, **WMD_CHECK_KW)
    res_b = twmd.sinkhorn_log_batched(
        w1, w2, pair_dists(emb[ids1.long()], emb[ids2.long()]), **WMD_CHECK_KW)
    conv = (it_k < WMD_CHECK_KW["max_iters"]) & (
        res_b.n_iters < WMD_CHECK_KW["max_iters"])
    conv_share = float(conv.float().mean())
    err_all = (res_b.cost - chk_k).abs()
    err = err_all[conv]
    if conv_share < WMD_CONVERGED_MIN_SHARE:
        fail(f"WMD check: only {conv_share:.3f} of the pairs converged in both "
             f"solvers at {WMD_CHECK_KW}")
    if not bool((err <= atol4 + 1e-4 * chk_k[conv].abs()).all()):
        fail(f"wmd_batched (sinkhorn_log_batched) differs from the "
             f"Sinkhorn-WMD kernel by {err.max().item()} > {atol4:.3e} + "
             f"1e-4*|WMD| on converged pairs at {WMD_CHECK_KW}")
    sub = docs[cand.indices[0].long()]
    ovm_chk = twmd.wmd_one_vs_many(sub, q.ids[0], q.weights[0], emb,
                                   **WMD_CHECK_KW)
    c32 = conv[:K_CAND]
    e_ovm = (ovm_chk - chk_k[:K_CAND]).abs()[c32]
    if not bool((e_ovm <= atol4 + 1e-4 * chk_k[:K_CAND][c32].abs()).all()):
        fail(f"wmd_one_vs_many differs from the kernel by {e_ovm.max().item()} "
             f"on converged pairs at {WMD_CHECK_KW}")
    torch.cuda.synchronize()
    t_ovm = time.perf_counter()
    twmd.wmd_one_vs_many(sub, q.ids[0], q.weights[0], emb, **KW_RERANK)
    torch.cuda.synchronize()
    ovm_ms = (time.perf_counter() - t_ovm) * 1e3 / sub.n_docs
    gaps = []
    for i in range(N_LP):
        c = dists(emb[ids1[i].long()], emb[ids2[i].long()])
        gaps.append(float(wmd_k[i]) - twmd.emd_exact_lp(w1[i], w2[i], c))
    if not all(math.isfinite(g) for g in gaps):
        fail("emd_exact_lp: non-finite gap")
    batched_ms = wall_ms(lambda: twmd.wmd_batched(ids1, w1, ids2, w2, emb,
                                                  **KW_RERANK), 1)
    log(f"WMD on {flat.numel()} pairs at {WMD_CHECK_KW}: {conv_share:.3f} "
        f"converged in both; there sinkhorn_log_batched vs kernel max |dWMD| "
        f"{err.max().item():.3e}, wmd_one_vs_many vs kernel "
        f"{e_ovm.max().item() if e_ovm.numel() else 0.0:.3e} (<= {atol4:.3e} "
        f"+ 1e-4*|WMD|); over all pairs {err_all.max().item():.3e}; at "
        f"the rerank's {KW_RERANK} (not converged, reported only): "
        f"{e_rerank:.3e}; wmd_one_vs_many {ovm_ms:.2f} ms per pair over "
        f"{sub.n_docs} pairs; kernel - exact EMD over {N_LP} pairs: max |gap| "
        f"{max(abs(g) for g in gaps):.3e}, mean {sum(gaps) / N_LP:.3e}")
    log(f"comparison checks: {time.perf_counter() - t_phase:.1f} s")

    # --- the paper's comparison: quadratic RWMD against LC-RWMD ---
    budget = min(4 * K_FINAL, n)
    comp = dict(
        quadratic_rwmd_ms=report["rwmd_pairwise"]["ms"],
        one_sided_ms=wall_ms(lambda: engine.one_sided(q)),
        streaming_kernel_ms=wall_ms(lambda: lc_rwmd_streaming(
            docs, q, emb, vocab_chunk=VOCAB_CHUNK, fuse="kernel"), 2),
        streaming_scan_ms=wall_ms(lambda: lc_rwmd_streaming(
            docs, q, emb, vocab_chunk=VOCAB_CHUNK, fuse="scan"), 2),
        symmetric_topk_ms=wall_ms(lambda: engine.symmetric_topk_streaming(
            q, budget), 1),
        sinkhorn_batched_ms=batched_ms,
        sinkhorn_kernel_ms=report["sinkhorn_wmd"]["ms"],
        wmd_one_vs_many_ms_per_pair=ovm_ms,
        emd_gap_max=max(abs(g) for g in gaps), emd_gap_mean=sum(gaps) / N_LP,
        wmd_batched_vs_kernel_converged=err.max().item(),
        wmd_converged_share=conv_share,
        wmd_batched_vs_kernel_all=err_all.max().item(),
        wmd_batched_vs_kernel_rerank=e_rerank,
        symmetric_budget=budget)
    for key in ("one_sided", "streaming_kernel", "streaming_scan",
                "symmetric_topk"):
        comp[f"quadratic_over_{key}"] = comp["quadratic_rwmd_ms"] / comp[f"{key}_ms"]
    torch.cuda.empty_cache()
    return comp


def profile_calls(calls: dict) -> dict:
    """Device time by kernel name and the device's busy share per call.

    ``torch.profiler`` (CUPTI) over one call each, after warm-up.  Busy
    share = summed kernel time / host wall time of the call; overlapping
    kernels would count twice (these calls run on one stream).
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue  # operator rows repeat their kernels' device time
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(e, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, e.key, e.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        out[name] = dict(
            wall_ms=wall_us / 1e3,
            device_busy_share=busy / wall_us if rows else None,
            top=[dict(name=k[:80], device_ms=d / 1e3, count=c)
                 for d, k, c in rows[:6]])
        log(f"profile {name}: wall {wall_us / 1e3:.2f} ms, device busy share "
            + (f"{busy / wall_us:.3f}" if rows else "not measured (no device time)")
            + "; " + ", ".join(f"{k[:40]} {d / 1e3:.2f} ms x{c}"
                               for d, k, c in rows[:4]))
    return out


def small_phase():
    """A small corpus on the card (kernels) and on the CPU (plain versions)."""
    import torch

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.core.pipeline import pruned_wmd_topk
    from repro_torch.data.synth import CorpusSpec, make_corpus

    c = make_corpus(CorpusSpec(n_docs=2048, vocab_size=4096, emb_dim=300,
                               h_max=48, mean_h=27.5, n_classes=16, seed=1),
                    device="cpu")
    eng_c = LCRWMDEngine(c.docs, c.emb, device="cpu")
    eng_g = LCRWMDEngine(c.docs, c.emb, device="cuda")
    q = c.docs[:16]
    # Near-zero distances carry the gram form's cancellation noise,
    # ~sqrt(eps_f32 * |e|^2), in both versions; that sets the absolute floor.
    emax2 = float((eng_c.emb_full ** 2).sum(1).max())
    atol = 4.0 * math.sqrt(2.0 ** -23 * emax2)
    for name in ("one_sided", "symmetric"):
        a = getattr(eng_g, name)(q).cpu()
        b = getattr(eng_c, name)(q)
        if a.shape != b.shape or not torch.allclose(a, b, rtol=1e-4, atol=atol):
            fail(f"small {name}: card and CPU differ by {(a - b).abs().max()}")
    for name in ("topk_streaming", "symmetric_topk_streaming"):
        a = getattr(eng_g, name)(q, 10)
        b = getattr(eng_c, name)(q, 11)
        check_topk(f"small {name}", a.dists.cpu(), a.indices.cpu(),
                   b.dists, b.indices, atol)
    cand = eng_c.topk_streaming(q, 16)
    a = eng_g.rerank_topk(q, cand.indices, 5, sinkhorn_kw=KW_RERANK)
    b = eng_c.rerank_topk(q, cand.indices, 5, sinkhorn_kw=KW_RERANK)
    if not torch.allclose(a.dists.cpu(), b.dists, rtol=1e-4, atol=atol):
        fail("small rerank_topk: card and CPU differ")
    ra = pruned_wmd_topk(c.docs, q, c.emb, k=5, engine=eng_g, sinkhorn_kw=KW_RERANK)
    rb = pruned_wmd_topk(c.docs, q, c.emb, k=5, engine=eng_c, sinkhorn_kw=KW_RERANK)
    if not torch.allclose(ra.topk.dists.cpu(), rb.topk.dists, rtol=1e-4, atol=atol):
        fail("small pruned_wmd_topk: card and CPU differ")
    if not bool((ra.topk.indices[:, 0].cpu() == torch.arange(16)).all()):
        fail("small pruned_wmd_topk: a query's top-1 is not itself")
    from repro_torch.core.lc_rwmd import lc_rwmd_streaming
    from repro_torch.kernels import ops

    qg, eg = q.to("cuda"), eng_g.emb_full
    want = eng_c.one_sided(q)
    for fuse in ("kernel", "scan"):
        a = lc_rwmd_streaming(eng_g.resident, qg, eg, vocab_chunk=VOCAB_CHUNK,
                              fuse=fuse).cpu()
        if not torch.allclose(a, want, rtol=1e-4, atol=atol):
            fail(f"small lc_rwmd_streaming({fuse}): card and CPU differ by "
                 f"{(a - want).abs().max()}")
    a = ops.rwmd_pairwise(eg, eng_g.resident.ids, eng_g.resident.weights,
                          qg.ids, qg.weights).cpu()
    b = ops.rwmd_pairwise(eng_c.emb_full, c.docs.ids, c.docs.weights, q.ids,
                          q.weights)
    if not torch.allclose(a, b, rtol=1e-4, atol=atol):
        fail(f"small rwmd_pairwise: card and CPU differ by {(a - b).abs().max()}")
    log(f"small (n=2048, m=300, atol {atol:.3f}): one_sided, symmetric, "
        "topk_streaming, symmetric_topk_streaming, rerank_topk, "
        "pruned_wmd_topk, lc_rwmd_streaming (kernel, scan) and rwmd_pairwise "
        "agree with the CPU plain versions")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.25,
                    help="Table IV set 2 scale (0.25: 700,000 docs)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(_build.SOURCES)} "
        f"kernel libraries (nvcc, sm_90a)")
    t_start = time.perf_counter()

    from repro_torch.core.lc_rwmd import LCRWMDEngine
    from repro_torch.core.pipeline import pruned_wmd_topk
    from repro_torch.data.synth import make_corpus, table_iv_spec

    # 2. small-size agreement, card vs CPU (cheap; before the big corpus)
    small_phase()

    # corpus + engine
    spec = table_iv_spec("set2", scale=args.scale)
    t0 = time.perf_counter()
    corpus = make_corpus(spec, device="cuda")
    log(f"corpus: n={spec.n_docs} vocab={spec.vocab_size} m={spec.emb_dim} "
        f"h_max={spec.h_max} mean_h={spec.mean_h} in {time.perf_counter() - t0:.1f} s")
    docs = corpus.docs
    t0 = time.perf_counter()
    engine = LCRWMDEngine(docs, corpus.emb, row_block=SYM_ROW_BLOCK)
    torch.cuda.synchronize()
    v_e = engine.emb_restricted.shape[0]
    log(f"engine: v_e={v_e}, _t_r {tuple(engine._t_r.shape)} "
        f"{engine._t_r.numel() * 4 / 1e9:.1f} GB, built in "
        f"{time.perf_counter() - t0:.1f} s")
    q = docs[:B]

    # 3. kernels against their plain versions
    report: dict = {}
    kernel_phase(engine, q, report)
    torch.cuda.empty_cache()

    # 4. the slice: main path, counts reset just before and read just after
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _build.reset_launches()
    cand = engine.topk_streaming(q, K_CAND)
    top = engine.rerank_topk(q, cand.indices, K_FINAL, sinkhorn_kw=KW_RERANK)
    d1 = engine.one_sided(q)
    res = pruned_wmd_topk(docs, q, corpus.emb, k=K_FINAL, engine=engine,
                          sinkhorn_kw=KW_RERANK)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"main path launches: {launches}")
    for name in ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd"):
        if launches.get(name, 0) < 1:
            fail(f"kernel {name} was not launched on the main path")

    self_ids = torch.arange(B, device="cuda", dtype=torch.int32)
    if tuple(top.indices.shape) != (B, K_FINAL) or not bool(
            torch.isfinite(top.dists).all()):
        fail("rerank_topk: bad shape or non-finite values")
    if not bool((top.indices[:, 0] == self_ids).all()):
        fail("quickstart: a query's top-1 after the rerank is not itself")
    if tuple(d1.shape) != (spec.n_docs, B) or not bool(torch.isfinite(d1).all()):
        fail("one_sided: bad shape or non-finite values")
    if not torch.allclose(cand.dists[:, 0], d1.amin(dim=0), rtol=1e-5, atol=1e-4):
        fail("topk_streaming's best distance disagrees with one_sided's min")
    if float(d1[self_ids.long(), self_ids.long()].max()) > 0.25:
        fail("one_sided: a query's distance to itself is not ~0")
    if not bool((res.topk.indices[:, 0] == self_ids).all()):
        fail("pruned_wmd_topk: a query's top-1 is not itself")
    exact_share = float(res.pruned_exact.float().mean())
    log(f"slice ok: all {B} self-queries ranked first after the rerank; "
        f"pruned_exact share {exact_share:.3f}; mean n_refined "
        f"{float(res.n_refined.float().mean()):.2f}")
    del d1

    # per-call times after warm-up (host clock, ending in a synchronize)
    times = {
        "topk_streaming_k32": wall_ms(lambda: engine.topk_streaming(q, K_CAND)),
        "rerank_topk_k5": wall_ms(lambda: engine.rerank_topk(
            q, cand.indices, K_FINAL, sinkhorn_kw=KW_RERANK)),
        "one_sided": wall_ms(lambda: engine.one_sided(q)),
        "pruned_wmd_topk_k5": wall_ms(lambda: pruned_wmd_topk(
            docs, q, corpus.emb, k=K_FINAL, engine=engine,
            sinkhorn_kw=KW_RERANK), 2),
    }
    log("per-call ms (B=64, after warm-up): " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    log(f"peak device memory over the main path: {peak_gb:.2f} GB "
        f"(max_memory_allocated)")
    profiles = profile_calls({
        "quickstart": lambda: engine.rerank_topk(
            q, engine.topk_streaming(q, K_CAND).indices, K_FINAL,
            sinkhorn_kw=KW_RERANK),
        "one_sided": lambda: engine.one_sided(q),
        "pruned_wmd_topk_k5": lambda: pruned_wmd_topk(
            docs, q, corpus.emb, k=K_FINAL, engine=engine,
            sinkhorn_kw=KW_RERANK),
    })

    # 5. the paper's comparison path (its own launch counts)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    comp = comparison_phase(engine, q, cand, report)
    log(f"comparison phase: {time.perf_counter() - t0:.1f} s")
    log("comparison: " + json.dumps(comp))

    sources = {
        "lc_rwmd_phase1": ("src/repro_torch/csrc/lc_rwmd_phase1.cu",
                           "src/repro/kernels/lc_rwmd_phase1.py:85"),
        "spmm_ell": ("src/repro_torch/csrc/spmm_ell.cu",
                     "src/repro/kernels/spmm_ell.py:90"),
        "fused_topk": ("src/repro_torch/csrc/fused_topk.cu",
                       "src/repro/kernels/fused_stream.py:294"),
        "sinkhorn_wmd": ("src/repro_torch/csrc/sinkhorn_wmd.cu",
                         "src/repro/kernels/sinkhorn_wmd.py:177"),
        "fused_chunk": ("src/repro_torch/csrc/fused_chunk.cu",
                        "src/repro/kernels/fused_stream.py:128"),
        "spmm_ell_dense": ("src/repro_torch/csrc/spmm_ell.cu",
                           "src/repro/kernels/spmm_ell.py:142"),
        "spmm_ell_naive": ("src/repro_torch/csrc/spmm_ell.cu",
                           "src/repro/kernels/spmm_ell.py:188"),
        "rwmd_pairwise": ("src/repro_torch/csrc/rwmd_pairwise.cu",
                          "src/repro/kernels/rwmd_pairwise.py:80"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        # B1-B4: the cascade's main path; B5-B7: the comparison path's
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=r.get("launches", launches.get(name, 0)),
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    slice_info = dict(
        n_docs=spec.n_docs, v_e=v_e, batch=B, per_call_ms=times,
        peak_gb=peak_gb, pruned_exact_share=exact_share, profiles=profiles,
        tolerances={k: r["tol"] for k, r in report.items()},
        comparison=comp,
        sinkhorn=dict(iters_mean=report["sinkhorn_wmd"]["iters_mean"],
                      iters_equal_share=report["sinkhorn_wmd"]["iters_equal_share"]))
    log("slice: " + json.dumps(slice_info))
    log(f"total after the build: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
