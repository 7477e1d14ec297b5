"""`repro_torch.index` — the cluster-routed serving index (counterpart of
``repro.index``).

:class:`ClusterIndex` partitions a
:class:`~repro_torch.core.lc_rwmd.SegmentedEngine`'s corpus into
``num_cells`` cells (k-centers or k-medoids,
:mod:`repro_torch.workloads.clustering`), holds each cell as its own
unpadded :class:`~repro_torch.core.lc_rwmd.EngineSegment`, and routes each
query to its ``top_p`` nearest cells by WCD centroid distance, with an
optional triangle-bound stage; the streaming fold then runs only over the
routed cells.  Exhaustive routing (``top_p = num_cells``, bound off)
equals the flat segmented scan bit for bit.
"""

from repro_torch.index.cluster_index import ClusterIndex, IndexConfig, RouteResult

__all__ = ["ClusterIndex", "IndexConfig", "RouteResult"]
