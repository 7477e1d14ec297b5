"""The paper's own architecture: distributed LC-RWMD similarity serving
(the port's copy of ``repro.configs.lcrwmd``).

Shape cells mirror the paper's Table IV datasets (Set 1: n=1M, h̄=107.5,
v_e=452,058; Set 2: n=2.8M, h̄=27.5, v_e=292,492) with m=300 word2vec
embeddings, plus an all-pairs cell for the symmetric D = max(D1, D2ᵀ) mode.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchSpec, ShapeCell, register


@dataclasses.dataclass(frozen=True)
class LCRWMDConfig:
    name: str = "lcrwmd"
    emb_dim: int = 300
    bf16_matmul: bool = True
    k: int = 16               # top-k results per query


@register
def lcrwmd() -> ArchSpec:
    cfg = LCRWMDConfig()
    smoke = LCRWMDConfig(name="lcrwmd-smoke", emb_dim=32, bf16_matmul=False)
    shapes = {
        # Paper Fig. 12: one query batch against the 1M-doc resident Set 1.
        "serve_set1_1m": ShapeCell(
            "serve_set1_1m", "lcrwmd_serve",
            dict(n_resident=1_048_576, h_resident=128, n_query=256,
                 h_query=128, vocab=452_058)),
        # Paper Fig. 13: Set 2 (2.8M docs, smaller histograms).
        "serve_set2_2p8m": ShapeCell(
            "serve_set2_2p8m", "lcrwmd_serve",
            dict(n_resident=2_800_000, h_resident=32, n_query=256,
                 h_query=32, vocab=292_492)),
        # Symmetric all-pairs mode (Sec. IV): D = max(D1, D2^T) in batches.
        "allpairs_64k": ShapeCell(
            "allpairs_64k", "lcrwmd_allpairs",
            dict(n_set1=65_536, n_set2=1024, h=64, vocab=262_144)),
        # Pruned-WMD cascade serving (Sec. III pruning): LC-RWMD + top-k.
        "serve_1m_k128": ShapeCell(
            "serve_1m_k128", "lcrwmd_serve",
            dict(n_resident=1_048_576, h_resident=128, n_query=64,
                 h_query=128, vocab=452_058, k=128)),
    }
    return ArchSpec(
        arch_id="lcrwmd", family="lcrwmd", model_cfg=cfg, smoke_cfg=smoke,
        shapes=shapes,
        notes="The paper's production workload; resident docs shard over "
              "(pod, data), vocabulary over model (DESIGN.md §4).",
    )
