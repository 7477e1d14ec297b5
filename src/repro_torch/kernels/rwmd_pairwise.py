"""Quadratic RWMD (the paper's baseline, Sec. III), fused per doc tile.

The CUDA kernel is ``csrc/rwmd_pairwise.cu`` (it replaces the TPU kernel
``repro.kernels.rwmd_pairwise.rwmd_pairwise_pallas``): it reads the
resident docs' embedding rows by id, so the (n, h1, m) gather the TPU
wrapper built never exists.  :func:`rwmd_pairwise_plain` is the same
function in plain PyTorch, gathering ``_PLAIN_DOCS`` docs at a time.

Both return (n, B) f32 ``max(d12, d21)`` per (resident doc, query), with a
masked minimum over nothing counted as 3.4e38 (so an empty resident doc or
an empty query gives about 3.4e38, and 0 on the empty side).
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import bf16_round
from repro_torch.kernels import _build

NAME = "rwmd_pairwise"
BIG = 3.4e38
_ROWS_MAX = 128    # doc word rows one CTA keeps in shared memory at a time
_DOCS_MAX = 8      # docs one CTA takes
_COLS_MAX = 1024   # query-word columns per group of queries
_PLAIN_DOCS = 2048  # docs per (docs, h1, B, h2) block of the plain version


def rwmd_pairwise_plain(emb: torch.Tensor, r_ids: torch.Tensor,
                        r_w: torch.Tensor, q_ids: torch.Tensor,
                        q_w: torch.Tensor, *,
                        bf16_matmul: bool = False) -> torch.Tensor:
    """Plain PyTorch version: emb (v, m), r_ids/r_w (n, h1), q_ids/q_w (B, h2)."""
    n, h1 = r_ids.shape
    b, h2 = q_ids.shape
    t2 = emb[q_ids.reshape(-1).long()]                       # (B*h2, m)
    b2 = (t2 * t2).sum(dim=-1)[None, :]
    m2 = (q_w > 0).reshape(1, 1, b, h2)
    w2 = torch.where(q_w > 0, q_w, torch.zeros_like(q_w))   # (B, h2)
    t2m = bf16_round(t2) if bf16_matmul else t2
    out = torch.empty((n, b), dtype=torch.float32, device=emb.device)
    for lo in range(0, n, _PLAIN_DOCS):
        hi = min(lo + _PLAIN_DOCS, n)
        t1 = emb[r_ids[lo:hi].reshape(-1).long()]            # (R*h1, m)
        a2 = (t1 * t1).sum(dim=-1)[:, None]
        t1m = bf16_round(t1) if bf16_matmul else t1
        sq = torch.clamp(a2 + b2 - 2.0 * (t1m @ t2m.T), min=0.0)
        c = torch.sqrt(sq).reshape(hi - lo, h1, b, h2)
        w1 = r_w[lo:hi]
        m1 = (w1 > 0)[:, :, None, None]
        row_min = torch.where(m2, c, BIG).amin(dim=3)        # (R, h1, B)
        d12 = (w1[:, :, None] * torch.where(
            m1[..., 0], row_min, 0.0)).sum(dim=1)            # (R, B)
        col_min = torch.where(m1, c, BIG).amin(dim=1)        # (R, B, h2)
        d21 = (col_min * w2[None]).sum(dim=-1)               # (R, B)
        out[lo:hi] = torch.maximum(d12, d21)
    return out


def tiling(h1: int, h2: int, b: int, m: int) -> tuple[int, int]:
    """(docs per CTA, queries per group) the kernel runs with: docs of more
    than ``_ROWS_MAX`` words one per CTA, and fewer docs where the column
    minima would not fit shared memory."""
    dt = max(1, min(_DOCS_MAX, _ROWS_MAX // h1))
    qg = max(1, min(b, _COLS_MAX // h2))
    # Prefer a group whose words fill whole 128-column tiles.
    for g in range(qg, 0, -1):
        if g * h2 % _build.GRAM_TC == 0:
            qg = g
            break
    while dt > 1 and smem_bytes(h1, h2, m, dt, qg) > _build.SMEM_LIMIT:
        dt -= 1
    return dt, qg


def smem_bytes(h1: int, h2: int, m: int, dt: int, qg: int) -> int:
    """Shared memory of one CTA (the sum ``csrc/rwmd_pairwise.cu`` allocates)."""
    tr = _build.GRAM_TR
    ldd = -(-min(dt * h1, _ROWS_MAX) // tr) * tr + 4
    return 4 * (m * ldd + 3 * ldd + _build.GRAM_KC * _build.GRAM_QS_LD
                + 2 * _build.GRAM_TC + dt * qg + ldd * qg + dt * qg * h2)


def rwmd_pairwise_cuda(emb: torch.Tensor, r_ids: torch.Tensor,
                       r_w: torch.Tensor, q_ids: torch.Tensor,
                       q_w: torch.Tensor, *,
                       bf16_matmul: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel: emb f32 (v, m), ids int32, weights f32."""
    _build.require(emb, torch.float32, 2, "emb")
    _build.require(r_ids, torch.int32, 2, "r_ids")
    _build.require(r_w, torch.float32, 2, "r_w")
    _build.require(q_ids, torch.int32, 2, "q_ids")
    _build.require(q_w, torch.float32, 2, "q_w")
    if r_ids.shape != r_w.shape or q_ids.shape != q_w.shape:
        raise ValueError("ids and weights must have the same shape")
    n, h1 = r_ids.shape
    b, h2 = q_ids.shape
    m = emb.shape[1]
    dt, qg = tiling(h1, h2, b, m)
    smem = smem_bytes(h1, h2, m, dt, qg)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"rwmd_pairwise needs {smem} bytes of shared memory "
                         f"per CTA (m={m}, h1={h1}, h2={h2}), more than the "
                         f"{_build.SMEM_LIMIT} one CTA may use")
    out = torch.empty((n, b), dtype=torch.float32, device=emb.device)
    lib = _build.lib(NAME)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_rwmd_pairwise(
            emb.data_ptr(), r_ids.data_ptr(), r_w.data_ptr(), q_ids.data_ptr(),
            q_w.data_ptr(), out.data_ptr(), n, b, h1, h2, m, dt, qg,
            int(bf16_matmul), stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def rwmd_pairwise(emb: torch.Tensor, r_ids: torch.Tensor, r_w: torch.Tensor,
                  q_ids: torch.Tensor, q_w: torch.Tensor, *,
                  bf16_matmul: bool = False) -> torch.Tensor:
    """Quadratic RWMD (n, B): the kernel on CUDA, the plain version on CPU."""
    if emb.is_cuda:
        return rwmd_pairwise_cuda(emb, r_ids, r_w, q_ids, q_w,
                                  bf16_matmul=bf16_matmul)
    if emb.device.type == "cpu":
        return rwmd_pairwise_plain(emb, r_ids, r_w, q_ids, q_w,
                                   bf16_matmul=bf16_matmul)
    raise ValueError(f"unsupported device {emb.device}")
