"""Time the async serving pipeline (``AsyncQueryServer`` with no mesh) of
the tree beside another tree's, on the same corpus and stream.

    python3 tools/async_loop_ab.py --other path/to/other/src [--scale 0.05]
        [--queries 4096] [--rounds 2] [--reps 3] [--out FILE]
        [--device cpu]

``--other`` is another tree's ``src`` directory (for example the parent
commit's, unpacked with ``git archive`` into a git-ignored directory).
Each version runs in a process of its own, which imports ``repro_torch``
from that ``src``, in rounds (other, tree, tree, other, repeated
``--rounds`` times).  A process builds Table IV set 2 at ``--scale`` on
the card (0.05: 140,000 docs), then an ``AsyncQueryServer`` with
``chip_smoke.py``'s serving configuration (k 16, batches of 64, h_max 48,
the symmetric refine and the Sinkhorn-WMD rerank), serves 64 queries to
warm up, and then ``--reps`` times the same stream of ``--queries``
resident docs as (ids, weights) queries: queries a second (first submit to last
answer), per-query p50 and p99, and the host seconds a batch of the
server's own metrics.  Every answer must find its own doc.  Prints one
JSON object with the card's name and power limit.

Needs a card (``--device cpu``: a dry run of the harness, at a small
``--scale`` and ``--queries``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH = 64
K = 16
WAIT_S = 300.0
HOST_METRICS = ("serving_dispatch_host_seconds", "serve_step_host_seconds",
                "serving_device_collect_seconds")


def child(scale: float, queries: int, reps: int, device: str) -> dict:
    """One version's runs (``repro_torch`` from the ``PYTHONPATH`` the
    parent set)."""
    import concurrent.futures

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.data.synth import make_corpus, table_iv_spec
    from repro_torch.serving import AsyncQueryServer, ServerConfig

    corpus = make_corpus(table_iv_spec("set2", scale=scale), device=device)
    docs, emb = corpus.docs, corpus.emb
    rng = np.random.default_rng(22)
    picks = rng.choice(docs.n_docs, queries, replace=False)
    sel = docs[torch.as_tensor(picks, device=docs.device)]
    ids, w = sel.ids.cpu().numpy(), sel.weights.cpu().numpy()
    stream = [(ids[j], w[j]) for j in range(queries)]
    cfg = ServerConfig(k=K, max_batch=BATCH, h_max=48, refine_symmetric=True,
                       rerank_wmd=True,
                       wmd_kw=dict(eps=0.05, eps_scaling=2, max_iters=100),
                       max_wait_s=1.0, device=device)
    srv = AsyncQueryServer(docs, emb, cfg)

    def serve(qs):
        n = len(qs)
        t_sub, t_done = np.zeros(n), np.zeros(n)
        futs = []
        t0 = time.perf_counter()
        for j, q in enumerate(qs):
            t_sub[j] = time.perf_counter()
            f = srv.submit(*q)
            f.add_done_callback(
                lambda _f, j=j: t_done.__setitem__(j, time.perf_counter()))
            futs.append(f)
        srv.flush()
        _, pending = concurrent.futures.wait(futs, timeout=WAIT_S)
        if pending:
            raise SystemExit(f"{len(pending)} futures unresolved")
        wall = time.perf_counter() - t0
        return [f.result() for f in futs], t_done - t_sub, wall

    def host_sums():
        m = srv.metrics_snapshot()["metrics"]
        return {n: (m[n]["series"][0]["sum"], m[n]["series"][0]["count"])
                for n in HOST_METRICS}

    serve(stream[:BATCH])                               # warm-up
    runs = []
    for _ in range(reps):
        h0 = host_sums()
        got, lat, wall = serve(stream)
        h1 = host_sums()
        if any(picks[j] not in a[0] for j, a in enumerate(got)):
            raise SystemExit("a query does not find its own doc")
        runs.append(dict(
            qps=queries / wall, p50_ms=float(np.percentile(lat, 50) * 1e3),
            p99_ms=float(np.percentile(lat, 99) * 1e3),
            host_ms_a_batch={
                n: (h1[n][0] - h0[n][0]) * 1e3 / max(1, h1[n][1] - h0[n][1])
                for n in HOST_METRICS}))
    srv.close()
    return dict(src=str(pathlib.Path(repro_torch.__file__).parents[1]),
                n_docs=docs.n_docs, runs=runs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=False,
                    help="another tree's src directory")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.scale, args.queries, args.reps, args.device)))
        return 0
    if not args.other:
        ap.error("--other is required")
    smi = "cpu (dry run)" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    versions = {"tree": str(ROOT / "src"),
                "other": str(pathlib.Path(args.other).resolve())}
    order = ["other", "tree", "tree", "other"] * args.rounds
    results: dict = {v: [] for v in versions}
    for v in order:
        env = dict(os.environ, PYTHONPATH=versions[v])
        r = subprocess.run(
            [sys.executable, __file__, "--child", "--scale", str(args.scale),
             "--queries", str(args.queries), "--reps", str(args.reps),
             "--device", args.device], env=env, capture_output=True,
            text=True, timeout=900)
        if r.returncode != 0:
            raise SystemExit(f"{v} failed:\n{r.stdout[-2000:]}"
                             f"{r.stderr[-4000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        results[v].append(out)
        print(f"{v}: " + ", ".join(f"{x['qps']:.0f} q/s" for x in out["runs"]),
              flush=True)
    report = dict(card=smi, order=order, scale=args.scale, results=results)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
