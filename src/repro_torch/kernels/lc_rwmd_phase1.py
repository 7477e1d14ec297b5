"""LC-RWMD phase 1: squared ``Z[w, j] = min_q ‖E[w] − T[j, q]‖²``.

The CUDA kernel is ``csrc/lc_rwmd_phase1.cu`` (it replaces the TPU kernel
``repro.kernels.lc_rwmd_phase1.lc_rwmd_phase1_pallas``); beside it,
:func:`phase1_sq_plain` is the same function in plain PyTorch.  Both return
the SQUARED min, clamped at 0, with invalid query words counted as 3.4e38;
the ops wrapper takes the sqrt.

The kernel multiplies only the valid (query, word) columns: a first launch
lists them on the device, without a host sync (:func:`valid_columns` is
that list in plain PyTorch), and the GEMM folds each tile's minima into Z²
by ``atomicMin``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

BIG = 3.4e38  # large finite sentinel of masked words, as on the TPU
NAME = "lc_rwmd_phase1"
TILE_ROWS = 128  # vocab rows per CTA of the kernel
TILE_COLS = 128  # valid columns per CTA of the kernel


def phase1_sq_plain(emb: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                    *, bf16_matmul: bool = False) -> torch.Tensor:
    """Plain PyTorch version: emb (v, m), t (B, h, m), valid (B, h) → (v, B)."""
    # Imported here: repro_torch.core imports the kernels, so a top-level
    # import would make this module fail when it is the first one imported.
    from repro_torch.core.distances import bf16_round

    v, m = emb.shape
    b, h, _ = t.shape
    tf = t.reshape(b * h, m)
    e2 = (emb * emb).sum(dim=-1)[:, None]
    t2 = (tf * tf).sum(dim=-1)[None, :]
    if bf16_matmul:
        et = torch.matmul(bf16_round(emb), bf16_round(tf).T)
    else:
        et = torch.matmul(emb, tf.T)
    sq = torch.clamp(e2 + t2 - 2.0 * et, min=0.0)
    sq = torch.where(valid.reshape(1, b * h) > 0, sq,
                     torch.full_like(sq, BIG))
    return sq.reshape(v, b, h).amin(dim=2)


def valid_columns(valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's column list in plain PyTorch: the flat ``query * h +
    word`` indices of ``valid`` (B, h) > 0 first, in (query, word) order,
    then the rest; and the number of valid ones, a (1,) int32 tensor."""
    flat = valid.reshape(-1) > 0
    cols = torch.argsort((~flat).to(torch.int8), stable=True)
    return cols.to(torch.int32), flat.sum(dtype=torch.int32).reshape(1)


def phase1_sq_cuda(emb: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
                   *, bf16_matmul: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel: emb (v, m), t (B, h, m), valid (B, h) → (v, B).

    The kernel fills Z² with 3.4e38 and lowers it by ``atomicMin``, so a
    query with no valid word keeps 3.4e38 in every row."""
    _build.require(emb, torch.float32, 2, "emb")
    _build.require(t, torch.float32, 3, "t")
    _build.require(valid, torch.float32, 2, "valid")
    v, m = emb.shape
    b, h, m_t = t.shape
    if m_t != m or tuple(valid.shape) != (b, h):
        raise ValueError(f"shape mismatch: emb {tuple(emb.shape)}, "
                         f"t {tuple(t.shape)}, valid {tuple(valid.shape)}")
    cols = torch.empty(b * h, dtype=torch.int32, device=emb.device)
    count = torch.empty(1, dtype=torch.int32, device=emb.device)
    out = torch.empty((v, b), dtype=torch.float32, device=emb.device)
    lib = _build.lib(NAME)
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_lc_rwmd_phase1(
            emb.data_ptr(), t.data_ptr(), valid.data_ptr(), cols.data_ptr(),
            count.data_ptr(), out.data_ptr(), v, b, h, m, int(bf16_matmul),
            stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def phase1_sq(emb: torch.Tensor, t: torch.Tensor, valid: torch.Tensor,
              *, bf16_matmul: bool = False) -> torch.Tensor:
    """Squared phase-1 Z (v, B): the kernel on CUDA, the plain version on CPU."""
    if emb.is_cuda:
        return phase1_sq_cuda(emb, t, valid, bf16_matmul=bf16_matmul)
    if emb.device.type == "cpu":
        return phase1_sq_plain(emb, t, valid, bf16_matmul=bf16_matmul)
    raise ValueError(f"unsupported device {emb.device}")
