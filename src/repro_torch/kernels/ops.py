"""Public wrappers around the kernels (counterpart of ``repro.kernels.ops``).

Responsibilities: dtype and layout policy (float32, contiguous), the query
gather, the sqrt of phase 1, and the route: the tensors' device decides.
CUDA tensors launch the hand-written kernels in ``csrc/``; CPU tensors take
each kernel's plain PyTorch version.  On a CUDA tensor a wrapper launches
its kernel or raises; nothing falls back.

The TPU wrappers' tile knobs (``block_v``, ``block_h``, ``block_n``) and
``interpret`` have no counterpart: the kernels choose their own tiles and
need no alignment padding.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_stream as _fs
from repro_torch.kernels import lc_rwmd_phase1 as _p1
from repro_torch.kernels import sinkhorn_wmd as _sk
from repro_torch.kernels import spmm_ell as _sp


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def _phase1(emb_f: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
            bf16_matmul: bool) -> torch.Tensor:
    z_sq = _p1.phase1_sq(emb_f, _f32(t), _f32(valid), bf16_matmul=bf16_matmul)
    return torch.sqrt(torch.clamp(z_sq, min=0.0))


def lc_rwmd_phase1(
    emb: torch.Tensor,      # (v, m) float
    q_ids: torch.Tensor,    # (B, h) int
    q_w: torch.Tensor,      # (B, h) float (0 = padding)
    *,
    bf16_matmul: bool = False,
) -> torch.Tensor:
    """Z (v, B) f32: min distance from every vocab word to each query doc."""
    emb_f = _f32(emb)
    b, h = q_ids.shape
    t = emb_f[q_ids.reshape(-1).long()].reshape(b, h, emb_f.shape[1])
    return _phase1(emb_f, t, q_w > 0, bf16_matmul)


def lc_rwmd_phase1_pregathered(
    emb: torch.Tensor,      # (v, m) float, the vocab axis of Z
    t: torch.Tensor,        # (B, h, m) float, PRE-GATHERED query word embeddings
    valid: torch.Tensor,    # (B, h) float 0/1
    *,
    bf16_matmul: bool = False,
) -> torch.Tensor:
    """Phase 1 with the query gather hoisted out (the engine shares it)."""
    return _phase1(_f32(emb), t, valid, bf16_matmul)


def spmm_ell(
    ids: torch.Tensor,   # (n, h) int
    w: torch.Tensor,     # (n, h) float
    z: torch.Tensor,     # (v, B) float
    *,
    mode: str = "blocked",
) -> torch.Tensor:
    """D (n, B) f32 = ELL-sparse(ids, w) @ z.

    Only ``mode="blocked"`` is ported; the reference's "dense" and "naive"
    formulations are TPU kernels still to port, and raise here.
    """
    if mode != "blocked":
        raise ValueError(f"spmm mode {mode!r} is not ported; use 'blocked'")
    return _sp.spmm_ell(ids.to(torch.int32).contiguous(), _f32(w), _f32(z))


def streaming_phase2_topk(
    r_ids: torch.Tensor,   # (n, h1) int resident ELL ids (into z's vocab axis)
    r_w: torch.Tensor,     # (n, h1) float resident weights (0 = padding)
    z: torch.Tensor,       # (v, B) f32 phase-1 output
    k: int,
    *,
    row_block: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase-2 ELL SpMM streamed straight into a per-query top-k carry.

    Returns ``(dists (B, k), indices (B, k))``, ``k = min(k, n)``, equal
    (ties included) to the top-k of the materialized (n, B) matrix in
    ``(distance, doc id)`` order.  On CUDA the fused top-k kernel runs
    (no (n, B) tensor is written); on CPU, the plain slab fold.
    """
    return _fs.phase2_topk(r_ids.to(torch.int32).contiguous(), _f32(r_w),
                           _f32(z), k, row_block=row_block)


def lc_rwmd_fused_topk(
    emb: torch.Tensor,      # (v, m) float
    q_ids: torch.Tensor,    # (B, h) int
    q_w: torch.Tensor,      # (B, h) float (0 = padding)
    r_ids: torch.Tensor,    # (n, h1) int resident ELL ids
    r_w: torch.Tensor,      # (n, h1) float resident weights (0 = padding)
    *,
    k: int,
    fuse: str = "jnp",
    row_block: int = 128,
    vocab_chunk: int = 512,
    bf16_matmul: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming one-sided LC-RWMD top-k: (B, k) dists + global doc ids.

    ``fuse``:
      "kernel": phase 1 (kernel) → phase 2 + top-k (fused kernel) on CUDA
                tensors, their plain versions on CPU tensors.
      "jnp":    the plain PyTorch fold on any device: phase 1 in
                ``vocab_chunk`` chunks, then ``row_block`` slabs folded into
                a streaming carry (the name is the reference's).
    """
    if fuse == "kernel":
        z = lc_rwmd_phase1(emb, q_ids, q_w, bf16_matmul=bf16_matmul)
        return streaming_phase2_topk(r_ids, r_w, z, k, row_block=row_block)
    if fuse == "jnp":
        from repro_torch.core.lc_rwmd import phase1_z

        z = phase1_z(_f32(emb), q_ids, q_w, bf16_matmul=bf16_matmul,
                     vocab_chunk=vocab_chunk)
        return _fs.phase2_topk_plain(r_ids, _f32(r_w), z, k,
                                     row_block=row_block)
    raise ValueError(f"unknown fuse mode {fuse!r}")


def sinkhorn_wmd(
    t1: torch.Tensor,    # (P, h1, m) candidate word embeddings (pre-gathered)
    w1: torch.Tensor,    # (P, h1) weights (0 = padding)
    t2: torch.Tensor,    # (P, h2, m) query word embeddings
    w2: torch.Tensor,    # (P, h2)
    *,
    eps: float = 0.01,
    eps_scaling: int = 4,
    eps_start: float = 1.0,
    max_iters: int = 500,
    tol: float = 1e-5,
    bf16_matmul: bool = False,
) -> torch.Tensor:
    """Batched Sinkhorn-WMD costs (P,) f32, cost tiles built on chip."""
    return _sk.sinkhorn(
        _f32(t1), _f32(w1), _f32(t2), _f32(w2), eps=eps,
        eps_scaling=eps_scaling, eps_start=eps_start, max_iters=max_iters,
        tol=tol, bf16_matmul=bf16_matmul)[0]
