"""Batched Sinkhorn-WMD: per pair, log-domain ε-scaled Sinkhorn → ⟨P, C⟩.

The CUDA kernel is ``csrc/sinkhorn_wmd.cu`` (it replaces the TPU kernel
``repro.kernels.sinkhorn_wmd.sinkhorn_wmd_pallas``); :func:`sinkhorn_plain`
is the same function in plain PyTorch, batched over pairs with per-pair
convergence masks.  Both return ``(cost (P,) f32, n_iters (P,) int32)``,
the iterations each pair ran over all ε levels.  Per pair both compute: the cost tile
``sqrt(max(|a|² + |b|² − 2ab, 0))``, log-domain Sinkhorn over a static ε
ladder (``max_iters`` and ``tol`` on the L1 error of the row marginal), a
row-max-stabilised plan with Altschuler rounding, and ``⟨P, C⟩``.

The kernel works on each pair's valid words only (:func:`valid_words` is
its list in plain PyTorch), in base 2, with two sweeps an iteration: see
the source.  Pairs whose padded widths are both at most 48 take one warp
each, four a CTA; wider pairs take a CTA of eight warps each, for any
widths whose cost tile fits one CTA's shared memory (the library's
``sinkhorn_smem_bytes``; about 230 words a side when h1 = h2).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import bf16_round
from repro_torch.kernels import _build

NAME = "sinkhorn_wmd"
NEG = -1e30  # log-domain mask sentinel (finite: no inf-inf NaN hazard)
MAX_LEVELS = 16
LOG2E = 1.4426950408889634


def eps_schedule(eps: float, eps_scaling: int, eps_start: float) -> tuple:
    """Geometric ε-scaling ladder as a python tuple."""
    if eps_scaling <= 1:
        return (float(eps),)
    ratio = (eps / eps_start) ** (1.0 / (eps_scaling - 1))
    return tuple(float(eps_start * ratio**i) for i in range(eps_scaling))


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Masked-safe logsumexp over finite −1e30 sentinels."""
    m = x.amax(dim=dim, keepdim=True)
    return m.squeeze(dim) + torch.log(torch.exp(x - m).sum(dim=dim) + 1e-38)


def _level_constants(eps, eps_scaling, eps_start, device):
    levels = eps_schedule(eps, eps_scaling, eps_start)
    lv = torch.tensor(levels, dtype=torch.float32, device=device)
    inv = torch.tensor([1.0 / e for e in levels], dtype=torch.float32,
                       device=device)
    return lv, inv


def sinkhorn_plain(t1, w1, t2, w2, *, eps: float = 0.01, eps_scaling: int = 4,
                   eps_start: float = 1.0, max_iters: int = 500,
                   tol: float = 1e-5, bf16_matmul: bool = False):
    """Plain PyTorch version: t1 (P, h1, m), w1 (P, h1), t2 (P, h2, m), w2."""
    a2 = (t1 * t1).sum(dim=-1)[:, :, None]
    b2 = (t2 * t2).sum(dim=-1)[:, None, :]
    if bf16_matmul:
        ab = torch.bmm(bf16_round(t1), bf16_round(t2).transpose(1, 2))
    else:
        ab = torch.bmm(t1, t2.transpose(1, 2))
    cost = torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))
    valid_a = w1 > 0
    valid_b = w2 > 0
    pair_mask = valid_a[:, :, None] & valid_b[:, None, :]
    neg = torch.tensor(NEG, dtype=torch.float32, device=t1.device)
    log_a = torch.where(valid_a, torch.log(torch.clamp(w1, min=1e-38)), neg)
    log_b = torch.where(valid_b, torch.log(torch.clamp(w2, min=1e-38)), neg)
    levels, invs = _level_constants(eps, eps_scaling, eps_start, t1.device)

    p = t1.shape[0]
    f = torch.zeros_like(w1)
    g = torch.zeros_like(w2)
    n_iters = torch.zeros((p,), dtype=torch.int32, device=t1.device)
    for li in range(levels.shape[0]):
        le, inv = levels[li], invs[li]
        err = torch.full((p,), 3.4e38, dtype=torch.float32, device=t1.device)
        it = 0
        while it < max_iters and bool((err > tol).any()):
            live = err > tol
            lk = torch.where(pair_mask, (g[:, None, :] - cost) * inv, neg)
            f_new = torch.where(valid_a, le * (log_a - _lse(lk, 2)), neg)
            lk2 = torch.where(pair_mask, (f_new[:, :, None] - cost) * inv, neg)
            g_new = torch.where(valid_b, le * (log_b - _lse(lk2, 1)), neg)
            log_p = torch.where(
                pair_mask, (f_new[:, :, None] + g_new[:, None, :] - cost) * inv,
                neg)
            row = torch.exp(log_p).sum(dim=2)
            err_new = (row - w1).abs().sum(dim=1)
            f = torch.where(live[:, None], f_new, f)
            g = torch.where(live[:, None], g_new, g)
            err = torch.where(live, err_new, err)
            n_iters += live.to(torch.int32)
            it += 1

    inv = invs[-1]
    log_p = torch.where(
        pair_mask, (f[:, :, None] + g[:, None, :] - cost) * inv, neg)
    mrow = log_p.amax(dim=2, keepdim=True)
    mrow = torch.where(mrow > -1e35, mrow, torch.zeros_like(mrow))
    plan = torch.exp(log_p - mrow)
    row = plan.sum(dim=2)
    scale = torch.where(valid_a, w1 / torch.clamp(row, min=1e-30),
                        torch.zeros_like(w1))
    plan = plan * scale[:, :, None]
    cost_val = torch.where(pair_mask, plan * cost, torch.zeros_like(cost)).sum(
        dim=(1, 2))
    return cost_val, n_iters


def valid_words(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's lists of each pair's valid words in plain PyTorch: the
    indices of ``w`` (P, h) > 0 first, in order, then the rest, as int32
    (P, h); and the number of valid ones, (P,) int32."""
    valid = w > 0
    idx = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    return idx.to(torch.int32), valid.sum(dim=1, dtype=torch.int32)


def sinkhorn_cuda(t1, w1, t2, w2, *, eps: float = 0.01, eps_scaling: int = 4,
                  eps_start: float = 1.0, max_iters: int = 500,
                  tol: float = 1e-5, bf16_matmul: bool = False):
    """Launch the CUDA kernel; raise ValueError where the pairs' cost tile
    does not fit one CTA's shared memory."""
    _build.require(t1, torch.float32, 3, "t1")
    _build.require(w1, torch.float32, 2, "w1")
    _build.require(t2, torch.float32, 3, "t2")
    _build.require(w2, torch.float32, 2, "w2")
    p, h1, m = t1.shape
    h2 = t2.shape[1]
    if (t2.shape[0], t2.shape[2]) != (p, m) or tuple(w1.shape) != (p, h1) \
            or tuple(w2.shape) != (p, h2):
        raise ValueError(f"shape mismatch: t1 {tuple(t1.shape)}, w1 "
                         f"{tuple(w1.shape)}, t2 {tuple(t2.shape)}, w2 "
                         f"{tuple(w2.shape)}")
    lib = _build.lib(NAME)
    need = lib.sinkhorn_smem_bytes(h1, h2)
    if need > _build.SMEM_LIMIT:
        raise ValueError(f"h1={h1}, h2={h2}: the pairs' cost tile needs "
                         f"{need} bytes of shared memory, more than one CTA's "
                         f"{_build.SMEM_LIMIT}")
    levels = eps_schedule(eps, eps_scaling, eps_start)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{len(levels)} eps levels; the kernel takes at most "
                         f"{MAX_LEVELS}")
    # log2(e) / eps per level, handed to the launch by value (host memory)
    k = (ctypes.c_float * len(levels))(*(LOG2E / e for e in levels))
    out = torch.empty((p,), dtype=torch.float32, device=t1.device)
    n_iters = torch.empty((p,), dtype=torch.int32, device=t1.device)
    with torch.cuda.device(t1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_sinkhorn_wmd(
            t1.data_ptr(), w1.data_ptr(), t2.data_ptr(), w2.data_ptr(),
            out.data_ptr(), n_iters.data_ptr(), ctypes.addressof(k), p, h1,
            h2, m, len(levels), max_iters, tol, int(bf16_matmul), stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out, n_iters


def sinkhorn(t1, w1, t2, w2, **kw):
    """(costs, iterations) per pair: the kernel on CUDA, the plain version on CPU."""
    if t1.is_cuda:
        return sinkhorn_cuda(t1, w1, t2, w2, **kw)
    if t1.device.type == "cpu":
        return sinkhorn_plain(t1, w1, t2, w2, **kw)
    raise ValueError(f"unsupported device {t1.device}")
