"""Quickstart: LC-RWMD in five minutes on synthetic news-like data.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card, the symmetric LC-RWMD runs the phase-1, ELL SpMM and
swapped-direction (d21) kernels, and the quadratic RWMD check runs the
quadratic RWMD kernel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (lc_rwmd_symmetric, rwmd_many_vs_many,
                              topk_smallest, wmd_pair)
from repro_torch.data.synth import CorpusSpec, make_corpus
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A corpus: 2,000 documents, 4,096-word vocabulary, topic-structured
    #    embeddings (stand-in for word2vec; see repro_torch/data/synth.py).
    corpus = make_corpus(CorpusSpec(
        n_docs=2000, vocab_size=4096, emb_dim=64, h_max=24, mean_h=14.0,
        n_classes=8, seed=0), device=dev)
    docs, emb = corpus.docs, torch.from_numpy(corpus.emb).to(dev)
    print(f"corpus: {docs.n_docs} docs, h_max={docs.h_max}, "
          f"emb {tuple(emb.shape)}")

    # 2. LC-RWMD: all resident docs vs a batch of 4 queries — two linear
    #    phases (vocab-to-query min distances, then a sparse matmul).
    queries = docs[:4]
    d = lc_rwmd_symmetric(docs, queries, emb)      # (2000, 4)
    print("LC-RWMD distance matrix:", tuple(d.shape))

    # 3. Top-k nearest documents per query.
    tk = topk_smallest(d.T, 5)
    top_ids = tk.indices.cpu().numpy()
    top_d = tk.dists.cpu().numpy()
    for j in range(4):
        print(f"query {j}: top-5 docs {top_ids[j]} "
              f"dists {np.round(top_d[j], 3)} "
              f"(labels {corpus.labels[top_ids[j]]}, "
              f"query label {corpus.labels[j]})")

    # 4. Sanity: LC-RWMD == quadratic RWMD (the paper's equivalence claim).
    d_quad = rwmd_many_vs_many(docs[:256], queries, emb)
    err = float((d[:256] - d_quad).abs().max())
    print(f"LC vs quadratic RWMD max |diff| on 256 docs: {err:.2e}")

    # 5. And RWMD lower-bounds WMD (Sinkhorn):
    i, j = int(top_ids[0, 1]), 0
    w = float(wmd_pair(docs.ids[i], docs.weights[i],
                       queries.ids[j], queries.weights[j], emb,
                       eps=0.02, eps_scaling=3, max_iters=200))
    r = float(d[i, j])
    print(f"pair ({i},{j}): RWMD={r:.4f} <= WMD~{w:.4f}: {r <= w + 1e-3}")
    return {"device": str(dev), "top_ids": top_ids, "top_dists": top_d,
            "lc_vs_quadratic_max_diff": err, "pair": (i, j), "rwmd": r,
            "wmd": w, "rwmd_le_wmd": r <= w + 1e-3}


if __name__ == "__main__":
    main()
