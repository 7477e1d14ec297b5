"""Causal GQA attention with an online softmax (flash attention).

Replaces ``flash_attention_pallas`` (``_flash_kernel``): the CUDA kernels in
``csrc/flash_attention.cu`` serve all the query heads of one KV head from
each K/V tile they stage in shared memory, carry the running max, sum and
accumulator of their rows in registers, and skip the KV tiles above the
diagonal.  bf16 runs both products on the tensor cores (``mma.sync``, P
from the score registers), float32 on the FMA units in IEEE float32.  The
plain version computes the same function with every score at once.

Semantics, both versions, as the reference kernel's: scores in float32
times ``dh**-0.5``; causal masking by the finite sentinel ``-1e30``;
``p = exp(s - max)`` rounded to ``v``'s dtype before ``P·V``, its sum ``l``
kept in float32; ``P·V`` accumulated in float32, divided by
``max(l, 1e-30)`` and cast to ``q``'s dtype.  Layouts are the reference's:
q ``(B, S, Hq, dh)``, k/v ``(B, T, Hkv, dh)``, query head ``h`` reading KV
head ``h // (Hq // Hkv)``.  Unlike the reference kernel, ``S`` and ``T``
need not be tile multiples (the model's prefill takes any prompt length).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NAME = "flash_attention"
HEAD_DIMS = (32, 64, 128)
KEY_TILE = 64  # keys per K/V tile: the running max moves tile by tile
_NEG = -1e30

# How far a bfloat16 output of the kernel may lie from its plain version's.
# Both round p = exp(s - max) to bf16, the kernel against its running max and
# the plain version against the row's max, and both round O to bf16.  The
# output roundings alone may differ by one bf16 ulp of a value, at most 2^-7
# of the largest |O| of its row; the row bar allows as much again for the p
# roundings.  Over a whole output the two paths' roundings give a relative
# RMS gap of 1.5e-3 (causal) and 2.3e-3 (non-causal, where nearly every
# tile's running max is below the row's), measured with the kernel's tile
# order emulated at S = T = 4,096 (tests/test_torch_kernels.py); the RMS
# bar is about twice the larger.  There a kernel that skips any one KV tile
# shows a row ratio of 0.25 or more.  Rounding p or not is below both bars
# on such inputs; ``p_rounding_probe`` shows it.
BF16_ROW_BAR = 2.0 ** -6
BF16_REL_RMS_BAR = 5e-3


def tiling(dh: int, group: int) -> tuple[int, int, int]:
    """The kernels' ``(rows per CTA, query heads per CTA, positions per CTA)``.

    A CTA has 256 rows (128 at dh = 128, where the tensor-core kernel's
    accumulators take twice the registers a row): ``gc`` query heads of one
    KV head times ``R / gc`` positions, ``gc`` the largest of 4, 2, 1 that
    divides the group and leaves at least 64 positions, so each warp's 32
    rows (16 at dh = 128; the float32 kernel's 8) are positions of one
    head.
    """
    r = 128 if dh == 128 else 256
    gc = next(c for c in (4, 2, 1) if c <= r // 64 and group % c == 0)
    return r, gc, r // gc


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: all (B, Hkv, group, S, T) scores at once.

    ``q_offset`` is the position of q's first row among the keys (causal
    masking keeps key ``t`` for row ``i`` when ``t <= q_offset + i``): a
    slice of a longer sequence's query rows gets its rows' outputs.
    """
    b, s, hq, dh = q.shape
    _, t, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, dh).to(torch.float32)
    sc = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32))
    sc.mul_(float(dh) ** -0.5)
    if causal:
        keep = (torch.arange(t, device=q.device)[None, :]
                <= torch.arange(s, device=q.device)[:, None] + q_offset)
        sc.masked_fill_(~keep, _NEG)
    p = sc.sub_(sc.amax(dim=-1, keepdim=True)).exp_()   # in place
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgst,bthd->bhgsd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32)) / den
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, dh).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, Hq, dh), k/v (B, T, Hkv, dh), all
    float32 or all bfloat16, contiguous; dh in 32, 64, 128."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _build.require(x, q.dtype, 4, name)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, s, hq, dh = q.shape
    _, t, hkv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {dh}")
    if hq % hkv or t < 1:
        raise ValueError(f"Hq {hq} must be a multiple of Hkv {hkv}, T >= 1")
    _, gc, _ = tiling(dh, hq // hkv)
    o = torch.empty_like(q)
    lib = _build.lib(NAME)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, t,
            hq, hkv, dh, gc, int(causal), int(q.dtype == torch.bfloat16),
            float(dh) ** -0.5, stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, S, Hq, dh) in q's dtype: the kernel on CUDA, the plain version on
    CPU."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    raise ValueError(f"unsupported device {q.device}")


def flash_hbm_bytes(b: int, s: int, t: int, hq: int, hkv: int, dh: int, *,
                    causal: bool = True, dtype_bytes: int = 2) -> int:
    """Bytes the kernel's CTAs read and write, for its tiling.

    Q is read once and O written once (B·S·Hq·dh each).  Each CTA reads the
    ``KEY_TILE``-key K and V tiles of its KV head up to its diagonal (all T
    keys without ``causal``; keys past T are zero-filled, not read), once
    for its ``gc`` query heads: a KV head's tiles are read ``group / gc``
    times per query tile.  Re-reads may hit the L2 cache; this counts what
    the CTAs ask for.
    """
    _, gc, bq = tiling(dh, hq // hkv)
    n_qt = -(-s // bq)
    keys = sum(min(t, (i + 1) * bq) if causal else t for i in range(n_qt))
    kv = 2 * b * hkv * (hq // hkv // gc) * keys * dh
    return (2 * b * s * hq * dh + kv) * dtype_bytes


def bf16_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a bf16 output ``got`` lies from ``want``: the relative RMS of
    the difference, the largest |difference| over the largest |want| of its
    row (the last axis), the largest |difference|, and whether both bars
    hold (``BF16_REL_RMS_BAR``, ``BF16_ROW_BAR``)."""
    w = want.float()
    d = got.float() - w
    rel = math.sqrt(float(d.square().sum()) / max(float(w.square().sum()), 1e-30))
    row = w.abs().amax(dim=-1, keepdim=True).clamp_(min=1e-30)
    ratio = float((d.abs() / row).max())
    return dict(rel_rms=rel, row_ratio=ratio, max_abs=float(d.abs().max()),
                ok=rel <= BF16_REL_RMS_BAR and ratio <= BF16_ROW_BAR)


def p_rounding_probe(t: int = 1024, device=None):
    """Inputs on which rounding p to bf16 shows in the output.

    One head, dh 64, 64 query rows and ``t`` keys, non-causal: key 0 scores
    0, the row's max, and every other key scores -0.6894073486328125 (exact
    in float32 from bf16 q and k), so p = 0.50187 rounds to 0.5 against the
    same max in any tile order; v is 1.  O = (1 + (t-1)/2) / l rounds to
    0.99609375, where a p kept in float32 gives 1.  Returns (q, k, v, O).
    """
    dh, rows = 64, 64
    q = torch.zeros((1, rows, 1, dh), dtype=torch.bfloat16, device=device)
    q[..., :2] = 8.0
    k = torch.zeros((1, t, 1, dh), dtype=torch.bfloat16, device=device)
    k[:, 1:, :, 0] = -0.6875
    k[:, 1:, :, 1] = -0.0019073486328125
    v = torch.ones((1, t, 1, dh), dtype=torch.bfloat16, device=device)
    p = math.exp(8.0 * (-0.6875 - 0.0019073486328125) * dh ** -0.5)
    o = (1.0 + (t - 1) * 0.5) / (1.0 + (t - 1) * p)
    want = torch.full_like(q, o)
    return q, k, v, want
