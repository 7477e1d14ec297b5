"""Corpus analytics end-to-end: cluster a corpus and extract near-duplicates.

The paper's clustering workload (Sec. I) on the centroid-degenerate
synthetic corpus — the regime where WCD is structurally blind but
word-level transport is not:

  1. greedy k-centers seeding + k-medoids refinement over LC-RWMD,
  2. the WCD-only baseline for contrast (paper Fig. 11, clustering edition),
  3. a near-duplicate graph from the same tiled all-pairs scheduler.

    PYTHONPATH=src python -m repro_torch.examples.cluster_corpus [--device cpu]

On the card, the clustering's symmetric bounds run the phase-1, ELL SpMM
and d21 kernels, and the all-pairs scheduler the phase-1 and ELL SpMM
kernels.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import LCRWMDEngine
from repro_torch.data.docs import DocSet
from repro_torch.data.synth import CorpusSpec, make_bimodal_corpus
from repro_torch.device import resolve_device
from repro_torch.workloads import (adjusted_rand_index, corpus_self_topk,
                                   duplicate_groups, kcenters, kmedoids,
                                   kmedoids_wcd_baseline,
                                   near_duplicate_graph, purity)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = make_bimodal_corpus(CorpusSpec(
        n_docs=256, vocab_size=1024, emb_dim=32, h_max=24, mean_h=16.0,
        n_classes=4, topic_noise=0.1, seed=17), device="cpu")
    # Plant a few exact duplicates for the dedup pass to find.
    ids = corpus.docs.ids.clone()
    w = corpus.docs.weights.clone()
    for dst, src in ((3, 200), (4, 200), (9, 150)):
        ids[dst] = ids[src]
        w[dst] = w[src]
    docs = DocSet(ids=ids, weights=w)
    engine = LCRWMDEngine(docs, corpus.emb, device=dev)
    labels = corpus.labels

    seeds = kcenters(engine, 4)
    print(f"k-centers seeds: {seeds.tolist()} "
          f"(classes {labels[seeds].tolist()})")

    res = kmedoids(engine, 4, n_iters=8, init=seeds)
    base = kmedoids_wcd_baseline(engine, 4, n_iters=8)
    ari, pur = adjusted_rand_index(res.labels, labels), purity(res.labels, labels)
    ari_b = adjusted_rand_index(base.labels, labels)
    pur_b = purity(base.labels, labels)
    print("clustering vs true topics (4 classes, chance ARI = 0):")
    print(f"  LC-RWMD k-medoids  ARI {ari:.3f}  purity {pur:.3f}"
          f"  ({res.n_iters} iters)")
    print(f"  WCD baseline       ARI {ari_b:.3f}  purity {pur_b:.3f}"
          f"  (centroid-degenerate corpus: WCD is blind by construction)")

    g = near_duplicate_graph(engine, 0.05, tile=64)
    groups = [sorted(gr.tolist()) for gr in duplicate_groups(g)]
    print(f"near-duplicate graph: {g.n_edges} edges at threshold 0.05; "
          f"groups: {groups}")

    tk = corpus_self_topk(engine, 5, tile=64)
    same = float(np.mean(labels[tk.indices.cpu().numpy()]
                         == labels[:, None]))
    print(f"5-NN label agreement across the corpus: {same:.3f}")
    return {"device": str(dev), "seeds": seeds, "ari": ari, "purity": pur,
            "ari_wcd": ari_b, "purity_wcd": pur_b, "n_edges": g.n_edges,
            "groups": groups, "knn_label_agreement": same,
            "medoids": res.medoids, "labels": res.labels}


if __name__ == "__main__":
    main()
