"""Corpus-analytics workloads on the LC-RWMD engine (counterpart of
``repro.workloads``).

  * :mod:`corpus_distance` — tiled all-pairs scheduling (self and
    cross-set) with running top-k merges; the (n, n) matrix never
    exists.
  * :mod:`clustering` — greedy k-centers seeding + k-medoids refinement
    with a WCD prefilter and optional Sinkhorn-WMD rerank.
  * :mod:`neighbors` — threshold / k-NN near-duplicate graphs,
    duplicate-group extraction and the ingest dedup gate.

Every entry point takes a prebuilt engine (an ``LCRWMDEngine`` or a
``SegmentedEngine``) and a ``tile`` that bounds each distance block at
(tile, tile).  Exports resolve lazily (PEP 562), as the package's own do,
so importing this package imports no torch-backed module.
"""

_EXPORTS = {
    "ClusterResult": "repro_torch.workloads.clustering",
    "adjusted_rand_index": "repro_torch.workloads.clustering",
    "kcenters": "repro_torch.workloads.clustering",
    "kmedoids": "repro_torch.workloads.clustering",
    "kmedoids_wcd_baseline": "repro_torch.workloads.clustering",
    "purity": "repro_torch.workloads.clustering",
    "CorpusTopKResult": "repro_torch.workloads.corpus_distance",
    "SelfPairScheduler": "repro_torch.workloads.corpus_distance",
    "TileBlock": "repro_torch.workloads.corpus_distance",
    "corpus_self_topk": "repro_torch.workloads.corpus_distance",
    "corpus_self_topk_distributed": "repro_torch.workloads.corpus_distance",
    "corpus_vs_corpus_topk": "repro_torch.workloads.corpus_distance",
    "DUPLICATE_SCORE_FLOOR": "repro_torch.workloads.neighbors",
    "NeighborGraph": "repro_torch.workloads.neighbors",
    "connected_components": "repro_torch.workloads.neighbors",
    "duplicate_groups": "repro_torch.workloads.neighbors",
    "ingest_dedup_mask": "repro_torch.workloads.neighbors",
    "knn_graph": "repro_torch.workloads.neighbors",
    "near_duplicate_graph": "repro_torch.workloads.neighbors",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'repro_torch.workloads' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value
    return value


def __dir__():
    return __all__
