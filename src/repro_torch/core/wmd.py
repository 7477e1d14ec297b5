"""Word Mover's Distance by batched log-domain Sinkhorn (kernel semantics).

The rerank stage of the cascade: every (candidate, query) pair is solved by
the Sinkhorn-WMD kernel (``repro_torch.kernels.ops.sinkhorn_wmd``) on CUDA,
by its plain version on CPU.  The reference's jnp solvers
(``sinkhorn_log(_batched)``, ``wmd_pair``) and the scipy oracle are not part
of this port yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops

# Solver kwargs the kernel understands; the reference's jnp-only extras are
# dropped, and anything else is rejected up front so a typo'd option cannot
# silently change behaviour.
_KERNEL_SINK_KEYS = frozenset(
    {"eps", "eps_scaling", "eps_start", "max_iters", "tol"})
_JNP_ONLY_SINK_KEYS = frozenset({"absorb_every"})


def wmd_batched_dispatch(t1: torch.Tensor, w1: torch.Tensor, t2: torch.Tensor,
                         w2: torch.Tensor, *, bf16_matmul: bool = False,
                         **sink_kw) -> torch.Tensor:
    """Batched WMD (P,) from pre-gathered embeddings t1 (P,h1,m), t2 (P,h2,m)."""
    unknown = set(sink_kw) - _KERNEL_SINK_KEYS - _JNP_ONLY_SINK_KEYS
    if unknown:
        raise TypeError(f"unknown sinkhorn kwargs: {sorted(unknown)}")
    kw = {k: v for k, v in sink_kw.items() if k in _KERNEL_SINK_KEYS}
    return ops.sinkhorn_wmd(t1, w1, t2, w2, bf16_matmul=bf16_matmul, **kw)


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
