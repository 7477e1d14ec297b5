"""Time variants of the naive ELL SpMM kernel (B6b) beside the tree's own.

Each variant is ``src/repro_torch/csrc/spmm_ell.cu`` with one choice
changed by a text substitution (a constant of the kernel, or the instance
a shape takes), built by ``nvcc`` for sm_90a into its own library under
``build/naive_probe/``.  At ``chip_smoke.py``'s four B6b shapes (the main
rows of Table IV set 2 at scale 0.25 against a seeded Z, the ``"scan"``
chunk shape on chunk 0 and a mid chunk, h = 160 and B = 256) each variant
must be bit-equal to the tree's kernel (all but ``one_row``, whose every
gather reads Z's row 0: the time the kernel takes when no Z load misses
L1); it is then timed by CUDA events beside the tree's kernel and the
blocked kernel (B2), in the order tree, variants, B2, then the reverse.  The tree's kernel is timed through its
wrapper; a variant through the same launcher with the tile rows its own
constants give.

    python3 tools/naive_probe.py [--out chiprun_out/naive_probe.json]

Needs a card and the CUDA toolkit's nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.lc_rwmd import restrict_vocab  # noqa: E402
from repro_torch.data.synth import make_corpus, table_iv_spec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import spmm_ell as sp  # noqa: E402

OUT_DIR = ROOT / "build" / "naive_probe"
REPS = 10

# name: (substitutions in spmm_ell.cu, each matching exactly once; the
# kernel's NAIVE_WARPS and NAIVE_CAP as the variant has them)
VARIANTS = {
    # key & (B >> 16) is 0 at these shapes, but not known to the compiler,
    # so the loads stay as many as before
    "one_row": ([("u < cnt ? (unsigned)p.x : last",
                  "(unsigned)p.x & (unsigned)(b >> 16)"),
                 ("u + 1 < cnt ? (unsigned)p.z : last",
                  "(unsigned)p.z & (unsigned)(b >> 16)")], 8, 1024),
    "general": ([("if (h <= SLOTS && b <= 32 * CW)\n    return launch_naive",
                  "if (false)\n    return launch_naive")], 8, 1024),
    "id_keys": ([("const bool wide = (long long)v * b >= (1LL << 32);",
                  "const bool wide = true;")], 8, 1024),
    "warps12": ([("constexpr int NAIVE_WARPS = 8;",
                  "constexpr int NAIVE_WARPS = 12;")], 12, 1024),
    "warps16": ([("constexpr int NAIVE_WARPS = 8;",
                  "constexpr int NAIVE_WARPS = 16;")], 16, 1024),
    "cap2048": ([("constexpr int NAIVE_CAP = 1024;",
                  "constexpr int NAIVE_CAP = 2048;")], 8, 2048),
    "stages3": ([("constexpr int NAIVE_STAGES = 2;",
                  "constexpr int NAIVE_STAGES = 3;")], 8, 1024),
    "u4": ([("constexpr int NAIVE_U = 8;", "constexpr int NAIVE_U = 4;")],
           8, 1024),
}

INEXACT = ("one_row",)


def tile_rows(h: int, warps: int, cap: int) -> int:
    """``spmm_ell.naive_tile_rows`` for a kernel of ``warps`` consumer
    warps and stages of ``cap`` slots."""
    rows = cap // h // warps * warps
    return min(max(rows, warps), sp.NAIVE_MAX_ROWS // warps * warps)


def build() -> dict:
    """The variants' libraries, built in parallel."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "spmm_ell.cu").read_text()
    procs = {}
    for name, (subs, _, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} does not match once")
            text = text.replace(old, new)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(OUT_DIR / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        f = dll.launch_spmm_ell_naive
        f.argtypes = _build.SIGNATURES["spmm_ell"]["launch_spmm_ell_naive"]
        f.restype = ctypes.c_int
        libs[name] = f
    return libs


def launcher(f, warps: int, cap: int, ids, w, z):
    n, h = ids.shape
    v, b = z.shape
    out = torch.empty((n, b), dtype=torch.float32, device=z.device)
    cw, vec = sp.column_plan(b, z.data_ptr(), out.data_ptr())
    rows = tile_rows(h, warps, cap)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        _build.check(f(ids.data_ptr(), w.data_ptr(), z.data_ptr(),
                       out.data_ptr(), n, h, v, b, rows, cw, int(vec),
                       stream), "naive variant")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "naive_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    libs = build()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    spec = table_iv_spec("set2", scale=0.25)
    corpus = make_corpus(spec, device="cuda")
    docs = corpus.docs
    sub, rows, _ = restrict_vocab(
        docs, torch.empty(spec.vocab_size, 1, device="cuda"))
    v_e = rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    z1 = torch.rand(v_e, cs.B, device="cuda", generator=g)
    shapes = cs.naive_shape_inputs(docs, spec.vocab_size, sub.ids, sub.weights,
                                   z1)
    print(f"corpus n={spec.n_docs} v_e={v_e}", flush=True)

    result = {"device": smi, "reps": REPS, "shapes": {}}
    for shape, (ids, w, z) in shapes.items():
        fns = {"tree": lambda: sp.spmm_ell_naive_cuda(ids, w, z)}
        ref = fns["tree"]()
        for name, (_, warps, cap) in VARIANTS.items():
            fns[name] = launcher(libs[name], warps, cap, ids, w, z)
            if name not in INEXACT and not torch.equal(fns[name](), ref):
                raise SystemExit(f"{name} at the {shape} shape: not bit-equal "
                                 "to the tree's kernel")
        fns["blocked"] = lambda: sp.spmm_ell_cuda(ids, w, z)
        runs = {k: [] for k in fns}
        order = list(fns)
        for k in order + order[::-1]:
            runs[k].append(cs.time_ms(fns[k], REPS))
        ms = {k: sum(r) / 2 for k, r in runs.items()}
        result["shapes"][shape] = {"n": ids.shape[0], "h": ids.shape[1],
                                   "b": z.shape[1], "ms": ms, "runs_ms": runs}
        print(shape, json.dumps({k: round(x, 4) for k, x in ms.items()}),
              flush=True)
        del ref
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
