"""Core algorithms of the port: LC-RWMD plus the baselines the paper compares
to (quadratic RWMD, WMD), top-k, WCD and the cascade."""

from repro_torch.core.distances import dists, safe_sqrt, sq_dists
from repro_torch.core.lc_rwmd import (
    EngineSegment,
    LCRWMDEngine,
    SegmentedEngine,
    SegmentTensors,
    lc_rwmd_one_sided,
    lc_rwmd_streaming,
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
from repro_torch.core.rwmd import (
    rwmd_many_vs_many,
    rwmd_one_vs_many,
    rwmd_pair,
    rwmd_pairs_from_t,
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
    resident_centroids,
    wcd_many_vs_many,
    wcd_one_vs_many,
)
from repro_torch.core.wmd import (
    SinkhornResult,
    emd_exact_lp,
    sinkhorn_log,
    sinkhorn_log_batched,
    wmd_batched,
    wmd_batched_dispatch,
    wmd_batched_from_t,
    wmd_candidate_values,
    wmd_one_vs_many,
    wmd_pair,
)

__all__ = [
    "dists", "safe_sqrt", "sq_dists",
    "EngineSegment", "LCRWMDEngine", "SegmentedEngine", "SegmentTensors",
    "lc_rwmd_one_sided", "lc_rwmd_streaming", "lc_rwmd_symmetric",
    "phase1_z", "phase1_z_from_t", "phase2_spmm", "restrict_vocab",
    "AdaptiveRefineBudget", "PrunedWMDResult", "QualityTier", "cascade_topk",
    "knn_classify", "pruned_wmd_topk",
    "rwmd_many_vs_many", "rwmd_one_vs_many", "rwmd_pair", "rwmd_pairs_from_t",
    "EMPTY_IDX", "StreamingTopK", "TopK", "lex_smallest", "merge_topk",
    "topk_from_candidates", "topk_smallest", "topk_smallest_cols",
    "centroids", "centroids_from_t", "resident_centroids",
    "wcd_many_vs_many", "wcd_one_vs_many",
    "SinkhornResult", "emd_exact_lp", "sinkhorn_log", "sinkhorn_log_batched",
    "wmd_batched", "wmd_batched_dispatch", "wmd_batched_from_t",
    "wmd_candidate_values", "wmd_one_vs_many", "wmd_pair",
]
