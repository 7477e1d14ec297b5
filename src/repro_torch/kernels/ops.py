"""Public wrappers around the kernels (counterpart of ``repro.kernels.ops``).

Responsibilities: dtype and layout policy (float32, contiguous), the query
gather, the sqrt of phase 1, and the route: the tensors' device decides.
CUDA tensors launch the hand-written kernels in ``csrc/``; CPU tensors take
each kernel's plain PyTorch version.  On a CUDA tensor a wrapper launches
its kernel or raises; nothing falls back.

The TPU wrappers' tile knobs (``block_v``, ``block_h``, ``block_n``,
``block_p``) and ``interpret`` have no counterpart: the kernels choose their
own tiles and need no alignment padding.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_stream as _fs
from repro_torch.kernels import lc_rwmd_phase1 as _p1
from repro_torch.kernels import rwmd_pairwise as _rw
from repro_torch.kernels import segment_spmm as _seg
from repro_torch.kernels import sinkhorn_wmd as _sk
from repro_torch.kernels import spmm_ell as _sp

_SPMM = {"blocked": _sp.spmm_ell, "dense": _sp.spmm_ell_dense,
         "naive": _sp.spmm_ell_naive}


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

    ``mode``: "blocked" (a warp gathers each doc row's Z rows), "dense" (the
    TPU's one-hot formulation: each row's slots summed vocab subtile by
    subtile, without the one-hot product's zeros) or "naive" (the seed
    formulation: a warp a doc row, its ids and weights staged into shared
    memory by bulk copies, zero-weight slots skipped).
    """
    if mode not in _SPMM:
        raise ValueError(f"unknown spmm mode {mode!r}")
    return _SPMM[mode](ids.to(torch.int32).contiguous(), _f32(w), _f32(z))


def lc_rwmd_fused(
    emb: torch.Tensor,      # (v, m) float
    q_ids: torch.Tensor,    # (B, h) int
    q_w: torch.Tensor,      # (B, h) float (0 = padding)
    r_ids: torch.Tensor,    # (n, h1) int resident ELL ids
    r_w: torch.Tensor,      # (n, h1) float resident weights (0 = padding)
    *,
    vocab_chunk: int = 512,
    fuse: str = "scan",
    bf16_matmul: bool = False,
) -> torch.Tensor:
    """Streaming phase-1→phase-2: D (n, B) f32 without a full Z (v, B).

    The vocabulary (padded with zero rows to a multiple of ``vocab_chunk``)
    is scanned in chunks; each chunk's Z is made and consumed into the
    running D at once, with the resident ids made chunk-relative and
    clipped and the weights of out-of-chunk slots zeroed, as in the
    reference (the fused kernel reads the ids as they are and skips the
    out-of-chunk slots: the same sum).

    ``fuse``:
      "kernel": the fused chunk kernel (Z of a chunk lives only in shared
                memory) on CUDA tensors, its plain version on CPU tensors.
      "scan":   phase 1 then the blocked SpMM per chunk (Z bounded at
                (vocab_chunk, B)), kernels on CUDA, plain versions on CPU.
      "jnp":    the plain chunk fold on any device (the name is the
                reference's).
    """
    if fuse not in ("kernel", "scan", "jnp"):
        raise ValueError(f"unknown fuse mode {fuse!r}")
    emb_f = _f32(emb)
    v, m = emb_f.shape
    b, h = q_ids.shape
    n = r_ids.shape[0]
    vc = vocab_chunk
    n_chunks = -(-v // vc)
    if n_chunks * vc > v:
        emb_f = torch.cat([emb_f, emb_f.new_zeros((n_chunks * vc - v, m))])
    t = emb_f[q_ids.reshape(-1).long()].reshape(b, h, m)
    valid = (q_w > 0).to(torch.float32)
    r_ids = r_ids.to(torch.int32).contiguous()
    r_w = _f32(r_w)
    d = torch.zeros((n, b), dtype=torch.float32, device=emb_f.device)
    for lo in range(0, n_chunks * vc, vc):
        e_c = emb_f[lo:lo + vc]
        if fuse == "kernel":
            _fs.fused_chunk(e_c, t, valid, r_ids, r_w, lo, d,
                            bf16_matmul=bf16_matmul)
        elif fuse == "scan":
            z = _phase1(e_c, t, valid, bf16_matmul)
            d += _sp.spmm_ell(*_fs.chunk_relative(r_ids, r_w, lo, vc), z)
        else:
            _fs.fused_chunk_plain(e_c, t, valid, r_ids, r_w, lo, d,
                                  bf16_matmul=bf16_matmul)
    return d


def streaming_phase2_topk(
    r_ids: torch.Tensor,   # (n, h1) int resident ELL ids (into z's vocab axis)
    r_w: torch.Tensor,     # (n, h1) float resident weights (0 = padding)
    z: torch.Tensor,       # (v, B) f32 phase-1 output
    k: int,
    *,
    row_block: int = 128,
    q_gid: torch.Tensor | None = None,      # (B,) global ids to self-exclude
    row_valid: torch.Tensor | None = None,  # (n,) bool row mask (tombstones)
    d21: torch.Tensor | None = None,        # (n, B) f32 maxed into D
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase-2 ELL SpMM streamed straight into a per-query top-k carry.

    Returns ``(dists (B, k), indices (B, k))``, ``k = min(k, n)``, equal
    (ties included) to the top-k of the materialized (n, B) matrix in
    ``(distance, doc id)`` order.  On CUDA the fused top-k kernel runs
    (no (n, B) tensor is written); on CPU, the plain slab fold.

    As in the reference: rows with ``row_valid`` False are +inf for every
    query, the pair (row ``q_gid[j]``, query j) is +inf, and
    ``row_valid=None`` equals an all-True mask.  ``d21`` (the port's
    symmetric fold) is maxed into each entry before the masks.
    """
    dev = z.device
    if q_gid is not None:
        q_gid = q_gid.to(device=dev, dtype=torch.int32).contiguous()
    if row_valid is not None:
        row_valid = row_valid.to(device=dev, dtype=torch.bool).contiguous()
    if d21 is not None:
        d21 = _f32(d21)
    return _fs.phase2_topk(r_ids.to(torch.int32).contiguous(), _f32(r_w),
                           _f32(z), k, row_block=row_block, q_gid=q_gid,
                           row_valid=row_valid, d21=d21)


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


def rwmd_pairwise(
    emb: torch.Tensor,      # (v, m)
    r_ids: torch.Tensor,    # (n, h1) resident ids
    r_w: torch.Tensor,      # (n, h1)
    q_ids: torch.Tensor,    # (B, h2) query ids
    q_w: torch.Tensor,      # (B, h2)
    *,
    bf16_matmul: bool = False,
) -> torch.Tensor:
    """Quadratic RWMD distance matrix (n, B) f32, fused per doc tile.

    The kernel reads the embedding rows by id: the (n, h1, m) gather the
    reference's wrapper hands its kernel is never built.
    """
    return _rw.rwmd_pairwise(_f32(emb), r_ids.to(torch.int32).contiguous(),
                             _f32(r_w), q_ids.to(torch.int32).contiguous(),
                             _f32(q_w), bf16_matmul=bf16_matmul)


def rwmd_d21(
    emb: torch.Tensor,      # (v, m)
    r_ids: torch.Tensor,    # (n, h1) resident ids
    r_w: torch.Tensor,      # (n, h1)
    q_ids: torch.Tensor,    # (B, h2) query ids
    q_w: torch.Tensor,      # (B, h2)
    *,
    bf16_matmul: bool = False,
) -> torch.Tensor:
    """The symmetric bound's swapped direction d21 (n, B) f32: for each
    query word the distance to the nearest valid word of the resident doc,
    summed with the query's weights (the quadratic RWMD kernel's d21 mode).
    An empty resident doc gives +inf; padded query words add nothing."""
    return _rw.rwmd_d21(_f32(emb), r_ids.to(torch.int32).contiguous(),
                        _f32(r_w), q_ids.to(torch.int32).contiguous(),
                        _f32(q_w), bf16_matmul=bf16_matmul)


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


def flash_attention(
    q: torch.Tensor,   # (B, S, Hq, D)
    k: torch.Tensor,   # (B, T, Hkv, D)
    v: torch.Tensor,   # (B, T, Hkv, D)
    *,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Fused causal GQA attention (flash). q (B,S,Hq,D); k/v (B,T,Hkv,D).

    The reference's signature, with its rule that S and T be multiples of
    the blocks (each capped at its length).  The kernel chooses its own
    tiles and takes any length; the model calls it below this check.
    """
    s, t = q.shape[1], k.shape[1]
    if s % min(block_q, s) or t % min(block_k, t):
        raise ValueError("pad seqs to block multiple")
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal)


def segment_spmm(
    src: torch.Tensor,   # (E,) int
    dst: torch.Tensor,   # (E,) int, sorted ascending (CSR edge order)
    feat: torch.Tensor,  # (N, D) float
    rad: torch.Tensor,   # (E,) float (0 at padding edges)
    n_out: int,
) -> torch.Tensor:
    """Fused GNN gather-scale-scatter: out[n] = sum_{dst=n} rad*feat[src].

    (n_out, D) f32; rows with no edge are 0.
    """
    return _seg.segment_spmm(src.to(torch.int32).contiguous(),
                             dst.to(torch.int32).contiguous(), _f32(feat),
                             _f32(rad), n_out)
