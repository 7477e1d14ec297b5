"""LC-RWMD phase 2: the ELL SpMM ``D[i, j] = Σ_p w[i, p] · Z[ids[i, p], j]``.

Three formulations, as in the reference, each a CUDA kernel in
``csrc/spmm_ell.cu`` beside its plain PyTorch version:

* blocked (:func:`spmm_ell`), replacing ``spmm_ell_pallas``: a warp per
  doc row lists the row's nonzero slots in shared memory (ballot and rank)
  and gathers their Z rows four at a time, each lane its
  :func:`column_plan` columns;
* dense (:func:`spmm_ell_dense`), replacing ``spmm_ell_dense_pallas``: a
  warp buckets its row's nonzero slots by vocab subtile and adds them
  subtile by subtile in ascending order, each subtile's partial sum into
  the row's (the one-hot product of the TPU kernel, without its zeros;
  a slot whose id lies outside [0, v) adds nothing, as there);
* naive (:func:`spmm_ell_naive`), replacing ``spmm_ell_naive_pallas``: the
  seed formulation, a warp a doc row, on persistent CTAs that walk tiles
  of :func:`naive_tile_rows` rows; a producer warp stages each tile's ids
  and weights into shared memory by bulk copies in an mbarrier ring, and
  the consumer warps skip zero-weight slots and gather the nonzero slots'
  Z rows eight at a time.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

NAME = "spmm_ell"
DENSE_NAME = "spmm_ell_dense"
NAIVE_NAME = "spmm_ell_naive"
DENSE_BV = 512  # vocab rows per subtile, as in the kernel
DENSE_MAX_H = 2048  # the dense kernel's widest ELL row (its shared memory)
NAIVE_WARPS = 8     # the naive kernel's consumer warps a CTA, as in the kernel
NAIVE_CAP = 1024    # slots a stage of its ring, as in the kernel
NAIVE_MAX_ROWS = 64  # rows a tile at most


def spmm_ell_plain(ids: torch.Tensor, w: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ids/w (n, h), z (v, B) → (n, B)."""
    return torch.einsum("nh,nhb->nb", w, z[ids.long()])


def column_plan(b: int, *ptrs: int) -> tuple[int, bool]:
    """How the blocked kernel's lanes cover B columns: ``(cw, vec)``, each
    lane owning ``cw`` adjacent columns of a chunk of ``32 * cw`` (1 up to
    B = 32, 2 up to 64, else 4, chunks of 128), loaded as one vector when
    ``vec``: B a multiple of ``cw`` and every pointer aligned to it."""
    cw = 1 if b <= 32 else 2 if b <= 64 else 4
    vec = b % cw == 0 and all(p % (4 * cw) == 0 for p in ptrs)
    return cw, vec


def spmm_ell_cuda(ids: torch.Tensor, w: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ids int32 / w f32 (n, h), z f32 (v, B)."""
    _check(ids, w, z)
    n, h = ids.shape
    b = z.shape[1]
    out = torch.empty((n, b), dtype=torch.float32, device=z.device)
    cw, vec = column_plan(b, z.data_ptr(), out.data_ptr())
    lib = _build.lib(NAME)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_spmm_ell(
            ids.data_ptr(), w.data_ptr(), z.data_ptr(), out.data_ptr(),
            n, h, b, cw, int(vec), stream)
    _build.check(code, NAME)
    _build.LAUNCHES[NAME] += 1
    return out


def spmm_ell(ids: torch.Tensor, w: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """D (n, B): the kernel on CUDA, the plain version on CPU."""
    return _route(spmm_ell_cuda, spmm_ell_plain, ids, w, z)


def _check(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor) -> None:
    _build.require(ids, torch.int32, 2, "ids")
    _build.require(w, torch.float32, 2, "w")
    _build.require(z, torch.float32, 2, "z")
    if ids.shape != w.shape:
        raise ValueError(f"ids {tuple(ids.shape)} != w {tuple(w.shape)}")
    if not ids.device == w.device == z.device:
        raise ValueError(f"ids, w and z must be on one device, got "
                         f"{ids.device}, {w.device}, {z.device}")


def _route(cuda_fn, plain_fn, ids, w, z):
    if z.is_cuda:
        return cuda_fn(ids, w, z)
    if z.device.type == "cpu":
        return plain_fn(ids, w, z)
    raise ValueError(f"unsupported device {z.device}")


def spmm_ell_dense_plain(ids: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                         *, block_v: int = DENSE_BV) -> torch.Tensor:
    """Plain PyTorch version of the dense formulation: per vocab subtile, the
    one-hot ``A[i, c] = Σ_p w[i,p]·[ids[i,p] = lo + c]`` times ``Z[lo:lo+bv]``,
    summed subtile by subtile in ascending order, as the kernel sums.
    ids/w (n, h), z (v, B) → (n, B)."""
    n = ids.shape[0]
    v, b = z.shape
    ids_l = ids.long()
    out = torch.zeros((n, b), dtype=torch.float32, device=z.device)
    for lo in range(0, v, block_v):
        nv = min(block_v, v - lo)
        inb = (ids_l >= lo) & (ids_l < lo + nv)
        a = torch.zeros((n, nv), dtype=torch.float32, device=z.device)
        a.scatter_add_(1, (ids_l - lo).clamp(0, nv - 1),
                       torch.where(inb, w, torch.zeros_like(w)))
        out += a @ z[lo:lo + nv]
    return out


def spmm_ell_dense_cuda(ids: torch.Tensor, w: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """Launch the dense kernel: ids int32 / w f32 (n, h), z f32 (v, B)."""
    _check(ids, w, z)
    n, h = ids.shape
    v, b = z.shape
    if not 1 <= h <= DENSE_MAX_H:
        raise ValueError(f"ELL width must be in 1..{DENSE_MAX_H}, got {h}")
    out = torch.empty((n, b), dtype=torch.float32, device=z.device)
    lib = _build.lib(NAME)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_spmm_ell_dense(
            ids.data_ptr(), w.data_ptr(), z.data_ptr(), out.data_ptr(),
            n, h, v, b, stream)
    _build.check(code, DENSE_NAME)
    _build.LAUNCHES[DENSE_NAME] += 1
    return out


def spmm_ell_dense(ids: torch.Tensor, w: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Dense-formulation D (n, B): the kernel on CUDA, the plain version on CPU."""
    return _route(spmm_ell_dense_cuda, spmm_ell_dense_plain, ids, w, z)


def spmm_ell_naive_plain(ids: torch.Tensor, w: torch.Tensor,
                         z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the seed formulation: the slots added in
    sequence.  ids/w (n, h), z (v, B) → (n, B)."""
    ids_l = ids.long()
    out = w[:, :1] * z[ids_l[:, 0]]
    for p in range(1, ids.shape[1]):
        out = out + w[:, p:p + 1] * z[ids_l[:, p]]
    return out


def naive_tile_rows(h: int) -> int:
    """Doc rows a tile of the naive kernel: the most whole rows, in warps'
    worth (so a multiple of 4), that fill one stage of ``NAIVE_CAP`` slots,
    at most ``NAIVE_MAX_ROWS``; rows wider than a warp's share of a stage
    take a tile of ``NAIVE_WARPS`` rows that streams through several
    stages."""
    rows = NAIVE_CAP // h // NAIVE_WARPS * NAIVE_WARPS
    return min(max(rows, NAIVE_WARPS), NAIVE_MAX_ROWS)


def spmm_ell_naive_cuda(ids: torch.Tensor, w: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """Launch the naive kernel: ids int32 / w f32 (n, h), z f32 (v, B);
    any n below 2**31, any h and B (h = 0 gives zeros, as the other modes).

    ``D[i] = Σ_p w[i, p] · Z[ids[i, p]]`` as one fmaf chain a column in
    slot order from +0 that skips zero-weight slots: for a finite Z that is
    the sum over every slot bit for bit (the blocked kernel's D), but where
    Z holds an inf or a NaN a zero-weight slot adds nothing here while the
    reference adds ``0 · inf`` = NaN."""
    _check(ids, w, z)
    n, h = ids.shape
    v, b = z.shape
    if n > 2**31 - 1:
        raise ValueError(f"at most 2**31 - 1 docs, got {n}")
    if h * naive_tile_rows(max(h, 1)) >= 2**31:
        raise ValueError(f"ELL width must be below {2**31 // NAIVE_WARPS}, "
                         f"got {h}")
    out = torch.empty((n, b), dtype=torch.float32, device=z.device)
    if h == 0:
        return out.zero_()
    cw, vec = column_plan(b, z.data_ptr(), out.data_ptr())
    lib = _build.lib(NAME)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.launch_spmm_ell_naive(
            ids.data_ptr(), w.data_ptr(), z.data_ptr(), out.data_ptr(),
            n, h, v, b, naive_tile_rows(h), cw, int(vec), stream)
    _build.check(code, NAIVE_NAME)
    _build.LAUNCHES[NAIVE_NAME] += 1
    return out


def spmm_ell_naive(ids: torch.Tensor, w: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
    """Seed-formulation D (n, B): the kernel on CUDA, the plain version on CPU."""
    return _route(spmm_ell_naive_cuda, spmm_ell_naive_plain, ids, w, z)
