"""Time the fused top-k kernel (B3) of the tree beside other versions of
its source, on the same inputs, in one process.

    python3 tools/topk_ab.py --other path/to/fused_topk.cu [...] [--out FILE]

Each other source (for example the parent commit's
``src/repro_torch/csrc/fused_topk.cu``, unpacked with ``git archive`` into
a git-ignored directory) is built by ``nvcc`` with the tree's flags into
``build/topk_ab/``, with ``-Xptxas -v`` (its registers and spills a
kernel are printed); it must keep the tree's C interface.  Inputs are the
main path's: Table IV set 2 at ``--scale`` (0.25: 700,000 docs), its
restricted ids and weights, and Z of docs 0-63.  The calls timed are
``chip_smoke.py``'s: k = 32; k = 32 with tombstones (every seventh row) and
self-exclusion; k = 20 with the d21 operand; k = 256 (the global carry);
and the k = 32 partial launch alone through the 32-bit and the
64-bit-offset variants.  Each is timed by CUDA events (10 launches after
a warm-up) in rounds over the versions (tree and others, then the
reverse, twice), and every version's results must equal the tree's (the
inputs are finite).  Prints one JSON object with the card's name and
power limit.

Needs a card and the CUDA toolkit's nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.lc_rwmd import LCRWMDEngine  # noqa: E402
from repro_torch.data.synth import make_corpus, table_iv_spec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_stream as fs  # noqa: E402
from repro_torch.kernels import rwmd_pairwise as rw  # noqa: E402

OUT_DIR = ROOT / "build" / "topk_ab"
REPS = 10


def load(src: pathlib.Path, tag: str) -> ctypes.CDLL:
    """Build ``src`` into its own library and load it; prints what ptxas
    reports of each kernel's registers and spills."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out = OUT_DIR / f"{tag}.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", str(_build.CSRC), "-o", str(out), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    info = [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(json.dumps({"ptxas": tag, "lines": info}))
    dll = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES[fs.NAME].items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path,
                    nargs="+")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = {"tree": load(_build.CSRC / "fused_topk.cu", "tree")}
    for i, src in enumerate(args.other):
        libs[f"{i}:{src.name}"] = load(src, f"other{i}")

    corpus = make_corpus(table_iv_spec("set2", scale=args.scale), device="cuda")
    eng = LCRWMDEngine(corpus.docs, corpus.emb)
    q = corpus.docs[:cs.B]
    r_ids = eng.resident_restricted.ids
    r_w = eng.resident_restricted.weights
    z = eng._phase1(eng._gather_flat(q.ids), q.weights)
    n, h = r_ids.shape
    v_e = z.shape[0]
    live = torch.arange(n, device="cuda") % 7 != 3
    gid = torch.arange(cs.B, dtype=torch.int32, device="cuda")
    d21 = rw.rwmd_d21_cuda(eng.emb_full, eng.resident.ids, eng.resident.weights,
                           q.ids, q.weights)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, n_ctas = fs.cta_rows(n, n_sm)
    pv = torch.empty((n_ctas, cs.B, 32), device="cuda")
    pi = torch.empty((n_ctas, cs.B, 32), dtype=torch.int32, device="cuda")

    def partial(v_arg):
        _build.check(_build.lib(fs.NAME).launch_fused_topk_partial(
            r_ids.data_ptr(), r_w.data_ptr(), z.data_ptr(), 0, 0, 0,
            pv.data_ptr(), pi.data_ptr(), n, n, h, v_arg, cs.B, 32, rows,
            torch.cuda.current_stream().cuda_stream), fs.NAME)
        return pv, pi

    calls = {
        "k32": lambda: fs.phase2_topk_cuda(r_ids, r_w, z, 32),
        "k32_masks": lambda: fs.phase2_topk_cuda(r_ids, r_w, z, 32,
                                                 row_valid=live, q_gid=gid),
        "k20_d21": lambda: fs.phase2_topk_cuda(r_ids, r_w, z, 20, d21=d21),
        "k256": lambda: fs.phase2_topk_cuda(r_ids, r_w, z, 256),
        "k32_partial": lambda: partial(v_e),
        "k32_wide_partial": lambda: partial(2 ** 31 // cs.B + 1),
    }
    ms = {name: {w: [] for w in libs} for name in calls}
    outs = {}
    order = list(libs)
    for which in order + order[::-1] + order + order[::-1]:
        _build._libs[fs.NAME] = libs[which]
        for name, fn in calls.items():
            ms[name][which].append(cs.time_ms(fn, REPS))
            got = fn()
            outs.setdefault(name, {})[which] = tuple(x.clone() for x in got)
    _build._libs.pop(fs.NAME)
    for name, o in outs.items():
        for which, got in o.items():
            if not all(torch.equal(a, b) for a, b in zip(o["tree"], got)):
                raise SystemExit(f"{name}: {which}'s results differ from the "
                                 "tree's")
    res = dict(card=smi, n_docs=n, v_e=v_e, batch=cs.B, reps=REPS, ms=ms,
               mean_ms={name: {w: sum(t) / len(t) for w, t in m.items()}
                        for name, m in ms.items()})
    line = json.dumps(res)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
