"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use, by ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface under
``build/repro_torch_kernels/`` at the checkout's root, and loaded with
``ctypes``.  All sources are compiled at once, one ``nvcc`` process each,
started together.  A library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.

Every exported launcher returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) never passes silently.

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

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("lc_rwmd_phase1", "spmm_ell", "fused_topk", "sinkhorn_wmd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

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
        # emb, t, valid, out, v, b, h, m, bf16, stream
        "launch_lc_rwmd_phase1": [P, P, P, P, I, I, I, I, I, P],
    },
    "spmm_ell": {
        # ids, w, z, out, n, h, b, stream
        "launch_spmm_ell": [P, P, P, P, I, I, I, P],
    },
    "fused_topk": {
        # ids, w, z, part_vals, part_idx, n, n_real, h, b, k, rows_per_cta, stream
        "launch_fused_topk_partial": [P, P, P, P, P, I, I, I, I, I, I, P],
        # in_vals, in_idx, out_vals, out_idx, n_in, b, k, stream
        "launch_topk_merge": [P, P, P, P, I, I, I, P],
    },
    "sinkhorn_wmd": {
        # t1, w1, t2, w2, levels, inv_levels, out, iters, p, h1, h2, m,
        # n_levels, max_iters, tol, bf16, stream
        "launch_sinkhorn_wmd": [P, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I,
                                P],
    },
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
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all() -> None:
    """Compile every missing kernel library, one nvcc each, in parallel."""
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


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            build_all()
            dll = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(dll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = dll
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
