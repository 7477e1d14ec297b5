"""A witness of the rate at which the card gathers scattered feature rows.

``chip_smoke.py`` times the gather-scale-scatter kernel (B9) beside this
Triton kernel on the same ``src`` and ``feat``.  It reads the rows
``feat[src[e]]`` as B9 does, but in no order and with no chain of sums:
each program loads ``BLOCK`` edges' rows at once and writes one float, the
sum of all they hold.  What it reaches is what the card gives these
gathers with nothing else in their way.  Needs ``triton`` and a card.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl

BLOCK = 64  # edges a program


@triton.jit
def _gather_sum(src_ptr, feat_ptr, out_ptr, n_edges, D: tl.constexpr,
                DP: tl.constexpr, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    e = pid * BLOCK + tl.arange(0, BLOCK)
    valid = e < n_edges
    s = tl.load(src_ptr + e, mask=valid, other=0).to(tl.int64)
    c = tl.arange(0, DP)
    rows = tl.load(feat_ptr + s[:, None] * D + c[None, :],
                   mask=valid[:, None] & (c[None, :] < D), other=0.0)
    tl.store(out_ptr + pid, tl.sum(rows))


def gather_sum(src: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """(ceil(E / BLOCK),) f32: each program's sum of its edges' feat rows;
    src int32 (E,), feat f32 (N, D) contiguous, both on the card."""
    e, d = src.shape[0], feat.shape[1]
    grid = triton.cdiv(e, BLOCK)
    out = torch.empty(grid, dtype=torch.float32, device=feat.device)
    _gather_sum[(grid,)](src, feat, out, e, D=d, DP=triton.next_power_of_2(d),
                         BLOCK=BLOCK)
    return out
