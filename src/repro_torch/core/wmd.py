"""Word Mover's Distance by log-domain Sinkhorn with ε-scaling.

The paper computes WMD with FastEMD (network simplex) on CPUs; as in the
reference, the on-device solver here is log-domain Sinkhorn with
ε-scaling (Cuturi 2013), which converges to the exact EMD value as ε→0.
:func:`emd_exact_lp` (scipy's HiGHS LP, on the host) is the exact oracle.

Two batched backends, routed by :func:`wmd_batched_dispatch` as the
reference routes them:

* ``use_kernel=False`` (the default): :func:`wmd_batched_from_t`, the
  reference's stabilized exp-domain solver :func:`sinkhorn_log_batched`
  (row-max renormalized kernel refreshed every ``absorb_every``
  iterations, per-pair convergence masks) in plain PyTorch;
* ``use_kernel=True``: the Sinkhorn-WMD kernel
  (``repro_torch.kernels.ops.sinkhorn_wmd``), which builds the cost tiles
  on chip; on CPU tensors its plain version.

All entry points take ELL-padded histograms: padding slots (weight 0) get
+inf cost rows/columns, i.e. a −inf log-kernel, which zeroes their plan
mass exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.distances import dists, pair_dists
from repro_torch.data.docs import DocSet
from repro_torch.kernels import ops

_NEG_INF = -1e30
_INF = float("inf")


class SinkhornResult(NamedTuple):
    cost: torch.Tensor          # ⟨P, C⟩ transport cost (the WMD estimate)
    n_iters: torch.Tensor       # iterations executed (across all ε levels)
    marginal_err: torch.Tensor  # final L1 violation of the row marginal


def _eps_levels(eps: float, eps_scaling: int, eps_start: float) -> list[float]:
    """The ε ladder in float32, geometric from ``eps_start`` down to ``eps``."""
    if eps_scaling <= 1:
        return [float(np.float32(eps))]
    return [float(x) for x in
            np.geomspace(eps_start, eps, eps_scaling).astype(np.float32)]


def _logsumexp(x: torch.Tensor, dim: int) -> torch.Tensor:
    m = x.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m.squeeze(dim) + torch.log(torch.exp(x - m).sum(dim=dim) + 1e-38)


def _sinkhorn_log_pairs(a, b, cost, *, eps: float = 0.01,
                        eps_scaling: int = 4, eps_start: float = 1.0,
                        max_iters: int = 500,
                        tol: float = 1e-5) -> SinkhornResult:
    """:func:`sinkhorn_log` over a leading pairs axis, each pair iterating
    until its own stopping rule holds (what mapping the solver over the
    pairs gives).  a (P, h1), b (P, h2), cost (P, h1, h2)."""
    valid_a = a > 0
    valid_b = b > 0
    log_a = torch.where(valid_a, torch.log(torch.clamp(a, min=1e-38)), _NEG_INF)
    log_b = torch.where(valid_b, torch.log(torch.clamp(b, min=1e-38)), _NEG_INF)
    big = torch.where(valid_a[:, :, None] & valid_b[:, None, :], cost, _INF)
    levels = _eps_levels(eps, eps_scaling, eps_start)
    p = a.shape[0]
    f = torch.zeros_like(a)
    g = torch.zeros_like(b)
    iters = torch.zeros(p, dtype=torch.int32, device=a.device)
    err = torch.full((p,), _INF, device=a.device)
    for lev in levels:
        it = torch.zeros(p, dtype=torch.int32, device=a.device)
        err = torch.full((p,), _INF, device=a.device)
        while True:
            live = (it < max_iters) & (err > tol)
            if not bool(live.any()):
                break
            f_new = lev * (log_a - _logsumexp((g[:, None, :] - big) / lev, 2))
            f_new = torch.where(valid_a, f_new, _NEG_INF)
            g_new = lev * (log_b - _logsumexp((f_new[:, :, None] - big) / lev, 1))
            g_new = torch.where(valid_b, g_new, _NEG_INF)
            log_p = (f_new[:, :, None] + g_new[:, None, :] - big) / lev
            row = torch.exp(log_p).sum(dim=2)
            err_new = (row - a).abs().sum(dim=1)
            f = torch.where(live[:, None], f_new, f)
            g = torch.where(live[:, None], g_new, g)
            err = torch.where(live, err_new, err)
            it = it + live.to(torch.int32)
        iters = iters + it
    plan = torch.exp((f[:, :, None] + g[:, None, :] - big) / levels[-1])
    # Rescale rows to satisfy the row marginal exactly (rounding step of
    # Altschuler et al. 2017) so the reported cost is a feasible value.
    row = plan.sum(dim=2)
    plan = plan * torch.where(valid_a, a / torch.clamp(row, min=1e-38),
                              0.0)[:, :, None]
    cost_val = torch.where(torch.isfinite(big), plan * big, 0.0).sum(dim=(1, 2))
    return SinkhornResult(cost=cost_val, n_iters=iters, marginal_err=err)


def sinkhorn_log(a, b, cost, *, eps: float = 0.01, eps_scaling: int = 4,
                 eps_start: float = 1.0, max_iters: int = 500,
                 tol: float = 1e-5) -> SinkhornResult:
    """Log-domain Sinkhorn with ε-scaling. a:(h1,), b:(h2,), cost:(h1,h2).

    Zero-mass entries (padding) are excluded via −inf log-marginals.
    Returns the *unregularized* transport cost ⟨P, C⟩ under the final plan.
    """
    r = _sinkhorn_log_pairs(a[None], b[None], cost[None], eps=eps,
                            eps_scaling=eps_scaling, eps_start=eps_start,
                            max_iters=max_iters, tol=tol)
    return SinkhornResult(*(x[0] for x in r))


def sinkhorn_log_batched(a, b, cost, *, eps: float = 0.01,
                         eps_scaling: int = 4, eps_start: float = 1.0,
                         max_iters: int = 500, tol: float = 1e-5,
                         absorb_every: int = 4) -> SinkhornResult:
    """Batched stabilized Sinkhorn with ε-scaling over a leading pairs axis.

    a:(P,h1), b:(P,h2), cost:(P,h1,h2).  All P problems share one loop per ε
    level with per-pair convergence masks: a pair whose row-marginal
    violation drops below ``tol`` freezes its scalings and its iteration
    count while the others go on.  The loop runs in the stabilized exp
    domain (two batched matvecs and two divisions an iteration); every
    ``absorb_every`` iterations the scalings are absorbed into the log-domain
    potentials and the row-max renormalized kernel is refreshed.

    Returns a :class:`SinkhornResult` of per-pair (P,) tensors.
    """
    p, h1 = a.shape
    h2 = b.shape[1]
    dev = a.device
    valid_a = a > 0
    valid_b = b > 0
    big = torch.where(valid_a[:, :, None] & valid_b[:, None, :], cost, _INF)
    levels = _eps_levels(eps, eps_scaling, eps_start)

    def refresh(f, g, lev):
        """Row-max-stabilized kernel K'[i,:] = exp(lk[i,:] - m[i]); the
        stored row scaling is w = u·exp(m), so w ⊙ (K' v) is the true row
        marginal."""
        lk = (f[:, :, None] + g[:, None, :] - big) / lev
        m = lk.amax(dim=2)
        m = torch.where(m > -1e35, m, 0.0)  # fully-masked rows
        return torch.exp(lk - m[:, :, None]), m

    f = torch.zeros((p, h1), device=dev)
    g = torch.zeros((p, h2), device=dev)
    iters = torch.zeros(p, dtype=torch.int32, device=dev)
    err = torch.full((p,), _INF, device=dev)
    for lev in levels:
        kmat, m = refresh(f, g, lev)
        w = torch.ones((p, h1), device=dev)
        v = torch.ones((p, h2), device=dev)
        s = kmat.sum(dim=2)  # K' v with v = 1
        it_pair = torch.zeros(p, dtype=torch.int32, device=dev)
        err = torch.full((p,), _INF, device=dev)
        it = 0
        while it < max_iters and bool((err > tol).any()):
            live = err > tol
            lv = live[:, None]
            w_new = torch.where(valid_a, a / torch.clamp(s, min=1e-30), 0.0)
            t = torch.einsum("pij,pi->pj", kmat, w_new)
            v_new = torch.where(valid_b, b / torch.clamp(t, min=1e-30), 0.0)
            # The clamps keep a cold-start transient (columns of K' fully
            # underflown before the first absorption) finite instead of
            # spawning 0·inf NaNs; the next refresh repairs it.
            s_new = torch.clamp(torch.einsum("pij,pj->pi", kmat, v_new), max=3e37)
            err_new = (torch.clamp(w_new * s_new, max=3e37) - a).abs().sum(dim=1)
            w = torch.where(lv, w_new, w)
            v = torch.where(lv, v_new, v)
            s = torch.where(lv, s_new, s)
            err = torch.where(live, err_new, err)
            it_pair = it_pair + live.to(torch.int32)
            it += 1
            if it % absorb_every == 0:
                # Fold the live pairs' scalings into the potentials and
                # refresh K'; frozen pairs keep w, v, m.
                f = torch.where(
                    lv & valid_a,
                    f + lev * (torch.log(torch.clamp(w, min=1e-30)) - m), f)
                g = torch.where(
                    lv & valid_b,
                    g + lev * torch.log(torch.clamp(v, min=1e-30)), g)
                k2, m2 = refresh(f, g, lev)
                # True u resets to 1, stored as w = exp(m); |m| is clamped so
                # w stays finite through cold-start overshoots.
                w = torch.where(lv, torch.exp(torch.clamp(m2, -80.0, 80.0)), w)
                v = torch.where(lv, 1.0, v)
                m = torch.where(lv, m2, m)
                kmat = k2
                s2 = torch.einsum("pij,pj->pi", k2, v)
                s = torch.where(lv, s2, s)
        # End-of-level absorption carries pure log-domain potentials forward.
        f = torch.where(valid_a,
                        f + lev * (torch.log(torch.clamp(w, min=1e-30)) - m),
                        _NEG_INF)
        g = torch.where(valid_b, g + lev * torch.log(torch.clamp(v, min=1e-30)),
                        _NEG_INF)
        iters = iters + it_pair

    log_p = (f[:, :, None] + g[:, None, :] - big) / levels[-1]
    # Row-max stabilization: the shift cancels in the row rescale below but
    # keeps exp() finite when an unconverged pair's potentials overshoot.
    mrow = log_p.amax(dim=2, keepdim=True)
    mrow = torch.where(mrow > -1e35, mrow, 0.0)
    plan = torch.exp(log_p - mrow)
    row = plan.sum(dim=2)
    plan = plan * torch.where(valid_a, a / torch.clamp(row, min=1e-30),
                              0.0)[:, :, None]
    cost_val = torch.where(torch.isfinite(big), plan * big, 0.0).sum(dim=(1, 2))
    return SinkhornResult(cost=cost_val, n_iters=iters, marginal_err=err)


def wmd_batched_from_t(t1, w1, t2, w2, **sink_kw) -> torch.Tensor:
    """Batched WMD from pre-gathered word embeddings.

    t1:(P,h1,m), w1:(P,h1), t2:(P,h2,m), w2:(P,h2): builds the (P,h1,h2)
    cost stack and solves all pairs in one batched Sinkhorn.  Returns (P,).
    """
    return sinkhorn_log_batched(w1, w2, pair_dists(t1, t2), **sink_kw).cost


def wmd_batched(ids1, w1, ids2, w2, emb, **sink_kw) -> torch.Tensor:
    """Batched WMD over P histogram pairs; ids*:(P,h), w*:(P,h). Returns (P,)."""
    return wmd_batched_from_t(emb[ids1.long()], w1, emb[ids2.long()], w2,
                              **sink_kw)


# Solver kwargs the kernel understands; the jnp-only extras are dropped when
# routing to it, and anything else is rejected up front so a typo'd option
# cannot silently change behaviour on one backend only.
_KERNEL_SINK_KEYS = frozenset(
    {"eps", "eps_scaling", "eps_start", "max_iters", "tol"})
_JNP_ONLY_SINK_KEYS = frozenset({"absorb_every"})


def wmd_batched_dispatch(t1: torch.Tensor, w1: torch.Tensor, t2: torch.Tensor,
                         w2: torch.Tensor, *, use_kernel: bool = False,
                         bf16_matmul: bool = False, **sink_kw) -> torch.Tensor:
    """Batched WMD (P,) from pre-gathered embeddings t1 (P,h1,m), t2 (P,h2,m).

    The one place that maps a ``sinkhorn_kw`` dict onto either the batched
    solver (:func:`wmd_batched_from_t`, the default) or the Sinkhorn-WMD
    kernel (``use_kernel=True``, which takes only the kernel's keys).
    """
    unknown = set(sink_kw) - _KERNEL_SINK_KEYS - _JNP_ONLY_SINK_KEYS
    if unknown:
        raise TypeError(f"unknown sinkhorn kwargs: {sorted(unknown)}")
    if use_kernel:
        kw = {k: v for k, v in sink_kw.items() if k in _KERNEL_SINK_KEYS}
        return ops.sinkhorn_wmd(t1, w1, t2, w2, bf16_matmul=bf16_matmul, **kw)
    return wmd_batched_from_t(t1, w1, t2, w2, **sink_kw)


def wmd_candidate_values(t1_flat: torch.Tensor, w1_flat: torch.Tensor,
                         t_q: torch.Tensor, q_w: torch.Tensor,
                         **dispatch_kw) -> torch.Tensor:
    """(B, budget) WMD values for B-major flattened candidate pairs.

    t1_flat/w1_flat: (B·budget, h1[, m]) candidate word embeddings+weights
    in query-major order (row ``q*budget + c`` is query q's c-th candidate);
    t_q/q_w: (B, h2, m)/(B, h2) query tensors, expanded here.
    """
    b = t_q.shape[0]
    budget = t1_flat.shape[0] // b
    vals = wmd_batched_dispatch(
        t1_flat, w1_flat,
        t_q.repeat_interleave(budget, dim=0),
        q_w.repeat_interleave(budget, dim=0),
        **dispatch_kw,
    )
    return vals.reshape(b, budget)


def wmd_pair(ids1, w1, ids2, w2, emb, **sink_kw) -> torch.Tensor:
    """WMD (Sinkhorn) between two padded histograms; returns a scalar f32."""
    c = dists(emb[ids1.long()], emb[ids2.long()])
    return sinkhorn_log(w1, w2, c, **sink_kw).cost


def wmd_one_vs_many(resident: DocSet, q_ids, q_w, emb, **sink_kw) -> torch.Tensor:
    """WMD of one query against every resident doc, (n,): :func:`wmd_pair`
    for each doc, solved together with per-pair stopping rules."""
    n = resident.n_docs
    t1 = emb[resident.ids.long()]                              # (n, h1, m)
    t2 = emb[q_ids.long()][None].expand(n, -1, -1)             # (n, h2, m)
    return _sinkhorn_log_pairs(resident.weights, q_w[None].expand(n, -1),
                               pair_dists(t1, t2), **sink_kw).cost


# ---------------------------------------------------------------------------
# Host-side exact oracle (tests / tiny refinement only)
# ---------------------------------------------------------------------------
def emd_exact_lp(a, b, cost) -> float:
    """Exact EMD via scipy linprog (HiGHS). Host-side oracle."""
    from scipy.optimize import linprog

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=np.float64)

    a, b, cost = host(a), host(b), host(cost)
    ia = a > 0
    ib = b > 0
    a, b, cost = a[ia], b[ib], cost[np.ix_(ia, ib)]
    h1, h2 = cost.shape
    # Equality constraints: row sums = a, col sums = b.
    a_eq = np.zeros((h1 + h2, h1 * h2))
    for i in range(h1):
        a_eq[i, i * h2:(i + 1) * h2] = 1.0
    for j in range(h2):
        a_eq[h1 + j, j::h2] = 1.0
    b_eq = np.concatenate([a, b])
    # Drop one redundant constraint (marginals both sum to the same mass).
    res = linprog(cost.reshape(-1), A_eq=a_eq[:-1], b_eq=b_eq[:-1],
                  bounds=(0, None), method="highs")
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    return float(res.fun)
