"""Serving launcher for the paper's workload: LC-RWMD top-k query serving
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 4096 --n-queries 64
    ... --device cpu   # the kernels' plain versions

A synthetic corpus is loaded into a :class:`QueryServer` on one device and
a stream of resident docs is served as queries; the self-recall@k says how
many found themselves.

``--full`` builds the production serve step, as the reference does: the
production mesh (``make_production_mesh``: (16, 16) over (data, model), or
(2, 16, 16) with ``--multi-pod``) and on it the paper's Fig. 12 cell
``build_cell("lcrwmd", "serve_set1_1m", mesh)``.  Every rank of a world of
256 (512) ranks runs it; it prints the reference's line and returns the
cell.  In any other world the mesh raises its ``ValueError``.
``--multi-pod`` without ``--full`` serves as without it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--n-queries", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--rerank-wmd", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.full:
        from repro_torch.launch.cells import build_cell
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        cell = build_cell("lcrwmd", "serve_set1_1m", mesh)
        print(f"[serve] production serve step built on {mesh.shape}; "
              "load the resident corpus on the fleet to start serving.")
        return {"cell": cell}

    from repro_torch.data.synth import CorpusSpec, make_corpus
    from repro_torch.serving.query_server import QueryServer, ServerConfig

    corpus = make_corpus(CorpusSpec(
        n_docs=args.n_docs, vocab_size=8192, emb_dim=64, h_max=32,
        mean_h=18.0, n_classes=8, seed=0), device="cpu")
    server = QueryServer(
        corpus.docs, corpus.emb,
        ServerConfig(k=args.k, max_batch=args.batch, h_max=32,
                     rerank_wmd=args.rerank_wmd, device=args.device))

    rng = np.random.default_rng(1)
    ids = corpus.docs.ids.numpy()
    w = corpus.docs.weights.numpy()
    picks = rng.integers(0, args.n_docs, args.n_queries)
    stream = [(ids[i], w[i]) for i in picks]

    t0 = time.perf_counter()
    answers = list(server.serve_stream(stream))
    dt = time.perf_counter() - t0
    hit = float(np.mean([picks[i] in set(a[0].tolist())
                         for i, a in enumerate(answers)]))
    print(f"[serve] {len(answers)} queries in {dt:.2f}s "
          f"({1e3 * dt / max(len(answers), 1):.1f} ms/q); "
          f"self-recall@{args.k}={hit:.3f}; stats={server.stats}")
    return {"n_served": len(answers), "seconds": dt,
            "ms_per_query": 1e3 * dt / max(len(answers), 1),
            "self_recall": hit, "stats": server.stats, "answers": answers,
            "picks": picks}


if __name__ == "__main__":
    main()
