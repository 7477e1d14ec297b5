"""Core algorithms of the port: LC-RWMD, top-k, WMD rerank, WCD, cascade."""

from repro_torch.core.distances import dists, safe_sqrt, sq_dists
from repro_torch.core.lc_rwmd import (
    LCRWMDEngine,
    SegmentTensors,
    lc_rwmd_one_sided,
    lc_rwmd_symmetric,
    phase1_z,
    phase1_z_from_t,
    phase2_spmm,
    restrict_vocab,
)
from repro_torch.core.pipeline import (
    AdaptiveRefineBudget,
    PrunedWMDResult,
    QualityTier,
    cascade_topk,
    knn_classify,
    pruned_wmd_topk,
)
from repro_torch.core.topk import (
    EMPTY_IDX,
    StreamingTopK,
    TopK,
    lex_smallest,
    merge_topk,
    topk_from_candidates,
    topk_smallest,
    topk_smallest_cols,
)
from repro_torch.core.wcd import (
    centroids,
    centroids_from_t,
    wcd_many_vs_many,
    wcd_one_vs_many,
)
from repro_torch.core.wmd import wmd_batched_dispatch, wmd_candidate_values

__all__ = [
    "dists", "safe_sqrt", "sq_dists",
    "LCRWMDEngine", "SegmentTensors", "lc_rwmd_one_sided", "lc_rwmd_symmetric",
    "phase1_z", "phase1_z_from_t", "phase2_spmm", "restrict_vocab",
    "AdaptiveRefineBudget", "PrunedWMDResult", "QualityTier", "cascade_topk",
    "knn_classify", "pruned_wmd_topk",
    "EMPTY_IDX", "StreamingTopK", "TopK", "lex_smallest", "merge_topk",
    "topk_from_candidates", "topk_smallest", "topk_smallest_cols",
    "centroids", "centroids_from_t", "wcd_many_vs_many", "wcd_one_vs_many",
    "wmd_batched_dispatch", "wmd_candidate_values",
]
