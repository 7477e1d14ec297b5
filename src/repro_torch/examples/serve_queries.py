"""End-to-end serving example (the paper's production use-case): a resident
corpus is loaded once; a stream of query documents is batched and answered
with top-k nearest neighbours; optional WMD re-rank.

    PYTHONPATH=src python -m repro_torch.examples.serve_queries [--n-docs 4096] [--n-queries 128]
    PYTHONPATH=src python -m repro_torch.examples.serve_queries --async   # pipelined server
    ... --device cpu   # the kernels' plain versions

``--async`` serves the same stream through :class:`AsyncQueryServer`:
``submit`` returns a future immediately and the worker thread overlaps each
batch's host prep with the previous batch's device execution (double
buffering) — compare the ms/query lines.  On the card each batch runs the
serve step: phase 1 and the fused top-k kernels, and with ``--rerank-wmd``
the Sinkhorn-WMD kernel.  The reference builds a one-device mesh here; the
port's servers take no mesh (one card).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.data.synth import CorpusSpec, make_corpus
from repro_torch.serving import AsyncQueryServer, QueryServer, ServerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--n-queries", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--rerank-wmd", action="store_true")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the double-buffered AsyncQueryServer")
    ap.add_argument("--metrics", action="store_true",
                    help="dump the server's Prometheus text exposition "
                         "after serving")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    corpus = make_corpus(CorpusSpec(
        n_docs=args.n_docs, vocab_size=8192, emb_dim=64, h_max=32,
        mean_h=18.0, n_classes=8, seed=1), device="cpu")
    cfg = ServerConfig(k=args.k, max_batch=32, h_max=32,
                       refine_symmetric=True, rerank_wmd=args.rerank_wmd,
                       max_wait_s=0.05, device=args.device)

    # Query stream: perturbed copies of random resident docs (so the true
    # nearest neighbour is known) + fresh random docs.
    rng = np.random.default_rng(0)
    stream, truth = [], []
    ids_np = corpus.docs.ids.numpy()
    w_np = corpus.docs.weights.numpy()
    for _ in range(args.n_queries):
        src = int(rng.integers(0, args.n_docs))
        ids = ids_np[src].copy()
        w = w_np[src].copy()
        drop = rng.random(len(w)) < 0.2      # drop 20% of words
        w = np.where(drop, 0.0, w)
        if w.sum() == 0:
            w = w_np[src].copy()
        stream.append((ids, w))
        truth.append(src)

    if args.use_async:
        with AsyncQueryServer(corpus.docs, corpus.emb, cfg) as server:
            t0 = time.perf_counter()
            futures = [server.submit(ids, w) for ids, w in stream]
            server.drain()
            answers = [f.result() for f in futures]
            dt = time.perf_counter() - t0
        mode = "async double-buffered"
    else:
        server = QueryServer(corpus.docs, corpus.emb, cfg)
        t0 = time.perf_counter()
        answers = list(server.serve_stream(stream))
        dt = time.perf_counter() - t0
        mode = "sync lock-step"

    recall = float(np.mean([truth[i] in set(a[0].tolist())
                            for i, a in enumerate(answers)]))
    stats = server.stats_snapshot()
    print(f"[{mode}] served {len(answers)} queries in {dt:.2f}s "
          f"({1e3 * dt / len(answers):.1f} ms/query incl. batching)")
    print(f"recall@{args.k} of the perturbed source doc: {recall:.3f}")
    print(f"server stats: {stats}")
    if args.metrics:
        print(server.obs.render_prometheus(), end="")
    assert recall > 0.9, "serving quality regression"
    return {"mode": mode, "n_served": len(answers), "seconds": dt,
            "ms_per_query": 1e3 * dt / len(answers), "recall": recall,
            "stats": stats, "answers": answers, "truth": truth}


if __name__ == "__main__":
    main()
