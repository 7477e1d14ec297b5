"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use, by ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface under
``build/repro_torch_kernels/`` at the checkout's root, and loaded with
``ctypes``.  The device functions that several kernels share live in
``csrc/tiles.cuh``.  All sources are compiled at once, one ``nvcc``
process each, started together.  A library's file name carries a hash of
its source, the shared headers and the flags, so an edited source is
rebuilt and a stale library is never loaded.

Every exported launcher returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) never passes silently.

Each first load of a library is reported to the cold-start sentinel
(:mod:`repro_torch.obs.sentinel`), which the serving plane arms after its
warm-up.

:data:`LAUNCHES` counts kernel launches by kernel name.  Each wrapper adds
one where it launches its kernel and nowhere else, so a run can show which
kernels its path went through.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

import repro_torch.device  # noqa: F401  (the float32 backend flags)
from repro_torch.obs import sentinel

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd",
           "fused_chunk", "rwmd_pairwise", "flash_attention", "segment_spmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

SMEM_LIMIT = 232448  # bytes of shared memory one CTA may use on the H100

#: Kernel launches by kernel name (reset with :func:`reset_launches`).
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# Exported launchers and their argument types (pointers and the stream as
# void*, sizes as int).  Every launcher returns an int (cudaError_t).
SIGNATURES = {
    "lc_rwmd_phase1": {
        # emb, t, valid, cols (scratch), count (scratch), out, v, b, h, m,
        # bf16, stream
        "launch_lc_rwmd_phase1": [P, P, P, P, P, P, I, I, I, I, I, P],
    },
    "spmm_ell": {
        # ids, w, z, out, n, h, b, columns a lane, vector loads, stream
        "launch_spmm_ell": [P, P, P, P, I, I, I, I, I, P],
        # ids, w, z, out, n, h, v, b, stream
        "launch_spmm_ell_dense": [P, P, P, P, I, I, I, I, P],
        # ids, w, z, out, n, h, v, b, rows a tile, columns a lane, vector
        # loads, stream
        "launch_spmm_ell_naive": [P, P, P, P, I, I, I, I, I, I, I, P],
    },
    "fused_topk": {
        # ids, w, z, row_valid, q_gid, d21 (each may be null), part_vals,
        # part_idx, n, n_real, h, v, b, k, rows_per_cta, stream
        "launch_fused_topk_partial": [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                      I, I, P],
        # in_vals, in_idx, out_vals, out_idx, n_in, b, k_in, k_out, stream
        "launch_topk_merge": [P, P, P, P, I, I, I, I, P],
    },
    "sinkhorn_wmd": {
        # t1, w1, t2, w2, out, iters, levels (host: n_levels floats of
        # log2(e) / eps), p, h1, h2, m, n_levels, max_iters, tol, bf16, stream
        "launch_sinkhorn_wmd": [P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, P],
    },
    "fused_chunk": {
        # emb_chunk, t, valid, ids, w, d (at the slab's first column), zsq
        # (scratch), cv, lo, m, nq, h, n, h1, ldd, bf16, stream
        "launch_fused_chunk": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                               P],
    },
    "rwmd_pairwise": {
        # emb, r_ids, r_w, q_ids, q_w, then scratch: cnt, doc_start, rows,
        # cols, gcol, carry_col, carry_d12; out, n, b, h1, h2, m, ctas,
        # full, bf16, stream
        "launch_rwmd_pairwise": [P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                                 I, I, I, I, I, P],
    },
    "flash_attention": {
        # q, k, v, o, b, s, t, hq, hkv, dh, gc, causal, bf16, scale, stream
        "launch_flash_attention": [P, P, P, P, I, I, I, I, I, I, I, I, I, F, P],
    },
    "segment_spmm": {
        # src, dst, feat, rad, out, n_out, n_edges, d, floats a load (4 or
        # 1), stream
        "launch_segment_spmm": [P, P, P, P, P, I, I, I, I, P],
    },
}

# Other exports: sizes a wrapper asks its library for (an int returned).
QUERIES = {
    # h1, h2: the bytes of shared memory one CTA of the kernel needs
    "sinkhorn_wmd": {"sinkhorn_smem_bytes": [I, I]},
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or CUDA_HOME)")


def _lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all() -> int:
    """Compile every missing kernel library, one nvcc each, in parallel;
    returns how many were compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return len(procs)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            built = not _lib_path(name).exists()
            build_all()
            dll = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in {**SIGNATURES[name],
                                 **QUERIES.get(name, {})}.items():
                f = getattr(dll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = dll
            sentinel.note_load(name, built)
        return _libs[name]


def check(code: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {code}")


def require(x: torch.Tensor, dtype: torch.dtype, ndim: int, name: str) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
