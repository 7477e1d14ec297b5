"""Carry state across from numpy: the same corpus and weights in both packages.

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


def transformer_params_from_numpy(tree, cfg, *, device=None) -> dict:
    """The reference's transformer parameters as the port's.

    ``tree`` is the reference's ``init_params`` pytree with numpy (or array)
    leaves: ``embed``, ``final_ln``, ``layers`` stacked ``(L, ...)`` by
    ``jax.vmap``, optionally ``prefix_layers`` (a list of one layer's
    dict each, deepseek-v2's leading dense layer), ``unembed`` and the
    ``bq``/``bk``/``bv`` biases; MLA and MoE leaves as they come.  The port
    keeps the same nesting, so both packages compute on the same weights.
    bfloat16 leaves stay bfloat16.
    """
    dev = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":   # numpy has no bfloat16 of its own
            return torch.tensor(a.astype(np.float32), device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return leaf(node)

    params = conv(tree)
    n_pre = len(params.get("prefix_layers", []))
    n = n_pre + params["layers"]["ln1"].shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"{n_pre} prefix and {n - n_pre} stacked layers, the "
                         f"config has {cfg.n_layers}")
    return params
