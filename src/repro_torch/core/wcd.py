"""Word Centroid Distance (paper Sec. III): the cheap, loose lower bound.

Centroid of a histogram = weighted average of its word embeddings; WCD
between two docs is the Euclidean distance between centroids.
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import dists
from repro_torch.data.docs import DocSet


def centroids(ds: DocSet, emb: torch.Tensor) -> torch.Tensor:
    """(n, m) f32 weighted-average embeddings (weights are L1-normalized)."""
    return centroids_from_t(ds.weights, emb[ds.ids.long()])


def centroids_from_t(weights: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Centroids from PRE-GATHERED word embeddings t (n, h, m), w (n, h).

    Callers holding an engine's pre-gathered resident targets skip the
    ``emb[ids]`` gather entirely.
    """
    return torch.einsum("nh,nhm->nm", weights, t)


def wcd_many_vs_many(set1: DocSet, set2: DocSet, emb: torch.Tensor) -> torch.Tensor:
    """(n1, n2) f32 centroid distances."""
    return dists(centroids(set1, emb), centroids(set2, emb))


def wcd_one_vs_many(resident: DocSet, q_ids: torch.Tensor, q_w: torch.Tensor,
                    emb: torch.Tensor) -> torch.Tensor:
    c1 = centroids(resident, emb)                               # (n, m)
    c2 = torch.einsum("h,hm->m", q_w, emb[q_ids.long()])        # (m,)
    return dists(c1, c2[None, :])[:, 0]
