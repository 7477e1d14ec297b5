"""Carry state across from numpy: the same corpus in both packages.

The tests push the JAX package's ``np.asarray(...)`` arrays through
:func:`from_numpy`, so the reference and the port compute on bit-identical
inputs.  The arrays are taken as they are (no renormalization).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.docs import DocSet
from repro_torch.device import resolve_device


def from_numpy(ids, weights, emb, *, device=None) -> tuple[DocSet, torch.Tensor]:
    """(ids (n, h) int, weights (n, h) float, emb (v, m)) → (DocSet, emb f32)."""
    dev = resolve_device(device)
    ids = np.asarray(ids, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.float32)
    if ids.shape != weights.shape:
        raise ValueError(f"ids {ids.shape} != weights {weights.shape}")
    # torch.tensor copies, so read-only views (a JAX array's) are fine.
    docs = DocSet(ids=torch.tensor(ids, device=dev),
                  weights=torch.tensor(weights, device=dev))
    return docs, torch.tensor(np.asarray(emb, dtype=np.float32), device=dev)
