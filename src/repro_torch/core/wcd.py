"""Word Centroid Distance (paper Sec. III): the cheap, loose lower bound.

Centroid of a histogram = weighted average of its word embeddings; WCD
between two docs is the Euclidean distance between centroids.
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import dists
from repro_torch.data.docs import DocSet

_CENTROID_ROWS = 8192   # docs per (rows, h, m) gather of resident_centroids


def centroids(ds: DocSet, emb: torch.Tensor) -> torch.Tensor:
    """(n, m) f32 weighted-average embeddings (weights are L1-normalized)."""
    return centroids_from_t(ds.weights, emb[ds.ids.long()])


def centroids_from_t(weights: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Centroids from PRE-GATHERED word embeddings t (n, h, m), w (n, h)."""
    return torch.einsum("nh,nhm->nm", weights, t)


def resident_centroids(ds: DocSet, emb: torch.Tensor) -> torch.Tensor:
    """(n, m) centroids of a resident corpus, gathered ``_CENTROID_ROWS``
    docs at a time: never an (n, h, m) tensor."""
    return torch.cat([centroids(ds[lo:lo + _CENTROID_ROWS], emb)
                      for lo in range(0, ds.n_docs, _CENTROID_ROWS)])


def wcd_many_vs_many(set1: DocSet, set2: DocSet, emb: torch.Tensor) -> torch.Tensor:
    """(n1, n2) f32 centroid distances."""
    return dists(centroids(set1, emb), centroids(set2, emb))


def wcd_one_vs_many(resident: DocSet, q_ids: torch.Tensor, q_w: torch.Tensor,
                    emb: torch.Tensor) -> torch.Tensor:
    c1 = centroids(resident, emb)                               # (n, m)
    c2 = torch.einsum("h,hm->m", q_w, emb[q_ids.long()])        # (m,)
    return dists(c1, c2[None, :])[:, 0]
