"""kNN document classification with the WMD pruning cascade (paper Fig. 14).

Compares three distance backends on the same labeled corpus:
WCD (cheap), LC-RWMD (this paper), pruned WMD (gold).

    PYTHONPATH=src python -m repro_torch.examples.knn_classify [--device cpu]
        [--n-docs 512] [--n-test 48]   # the reference's sizes by default

On the card, LC-RWMD runs the phase-1, ELL SpMM and d21 kernels; the
cascade's stage 1 the same, and its rerank the Sinkhorn-WMD kernel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (AdaptiveRefineBudget, knn_classify,
                              lc_rwmd_symmetric, pruned_wmd_topk,
                              topk_smallest, wcd_many_vs_many)
from repro_torch.data.synth import CorpusSpec, make_corpus
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--n-test", type=int, default=48,
                    help="queries: the first N docs, each left out of its "
                         "own neighbours")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    corpus = make_corpus(CorpusSpec(
        n_docs=args.n_docs, vocab_size=2048, emb_dim=48, h_max=16,
        mean_h=10.0, n_classes=4, seed=9), device=dev)
    docs, emb = corpus.docs, torch.from_numpy(corpus.emb).to(dev)
    labels = torch.from_numpy(corpus.labels).to(dev)
    n_test, k = args.n_test, 7
    queries = docs[:n_test]
    diag = torch.arange(n_test, device=dev)

    def acc(pred):
        return float(np.mean(np.asarray(pred) == corpus.labels[:n_test]))

    def no_self(d):
        d = d.T.clone()
        d[diag, diag] = float("inf")
        return d

    # WCD
    d = no_self(wcd_many_vs_many(docs, queries, emb))
    a_wcd = acc(knn_classify(topk_smallest(d, k), labels, 4).cpu())

    # LC-RWMD
    d = no_self(lc_rwmd_symmetric(docs, queries, emb))
    a_rwmd = acc(knn_classify(topk_smallest(d, k), labels, 4).cpu())

    # pruned WMD (Sinkhorn refinement on LC-RWMD candidates).  The refine
    # budget adapts to the corpus: grown geometrically from the observed
    # pruned_exact failure rate instead of a static 4·k guess.
    budget = AdaptiveRefineBudget(k=k + 1, n_resident=docs.n_docs)
    sink = dict(eps=0.02, eps_scaling=3, max_iters=150)
    for _ in range(6):
        used = budget.budget
        res = pruned_wmd_topk(docs, queries, emb, k=k + 1,
                              refine_budget=used, sinkhorn_kw=sink)
        exact = res.pruned_exact.cpu().numpy()
        # Stop on exactness, saturation, or a failure rate already inside
        # the target (update() leaves the budget alone -> no progress).
        if exact.all() or budget.saturated or budget.update(exact) == used:
            break
    # drop the self-match column per query
    idx = res.topk.indices.cpu().numpy()
    d_ = res.topk.dists.cpu().numpy()
    preds = []
    for j in range(n_test):
        keep = [(i, v) for i, v in zip(idx[j], d_[j]) if i != j][:k]
        votes = corpus.labels[[i for i, _ in keep]]
        preds.append(np.bincount(votes, minlength=4).argmax())
    a_wmd = acc(np.asarray(preds))
    refined = float(np.mean(res.n_refined.cpu().numpy()))

    print(f"kNN accuracy (k={k}, {n_test} queries, 4 classes, chance=0.25):")
    print(f"  WCD      {a_wcd:.3f}   (loose bound, paper Fig. 11)")
    print(f"  LC-RWMD  {a_rwmd:.3f}   (this paper)")
    print(f"  WMD      {a_wmd:.3f}   (pruned cascade, paper Fig. 14)")
    print(f"mean WMD evals/query: {refined:.1f} of {docs.n_docs} docs "
          f"(adaptive budget {used}, exact={bool(exact.all())})")
    return {"device": str(dev), "acc_wcd": a_wcd, "acc_rwmd": a_rwmd,
            "acc_wmd": a_wmd, "mean_wmd_evals": refined, "budget": used,
            "exact": bool(exact.all())}


if __name__ == "__main__":
    main()
