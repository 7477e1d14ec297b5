"""Document-set containers for LC-RWMD (counterpart of ``repro.data.docs``).

Documents are word histograms in ELL-padded layout: every histogram is
padded to a fixed ``h_max`` words.  Padding slots carry ``weight == 0`` and
``word id == 0``; every consumer masks on ``weight > 0``.  A CSR view is
kept host-side (numpy) for parity with the paper's data structures.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DocSet:
    """A set of word histograms in ELL-padded layout.

    Attributes:
      ids:     int32 (n, h_max) word ids into the embedding table rows.
               Padding slots hold 0 (masked out by ``weights``).
      weights: float32 (n, h_max) L1-normalized term weights per doc.
               Padding slots hold exactly 0.
    """

    ids: torch.Tensor
    weights: torch.Tensor

    @property
    def n_docs(self) -> int:
        return self.ids.shape[0]

    @property
    def h_max(self) -> int:
        return self.ids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.ids.device

    @property
    def mask(self) -> torch.Tensor:
        """bool (n, h_max): True at real (non-padding) word slots."""
        return self.weights > 0

    @property
    def lengths(self) -> torch.Tensor:
        """int32 (n,): number of real words per doc."""
        return self.mask.sum(dim=-1).to(torch.int32)

    def slice_rows(self, start: int, size: int) -> "DocSet":
        """Rows ``[start, start + size)``, clipped at the end (a view, not
        padded; the reference's ``dynamic_slice`` pads nothing either, but
        moves a start that runs past the end back)."""
        return DocSet(ids=self.ids[start:start + size],
                      weights=self.weights[start:start + size])

    def __getitem__(self, idx) -> "DocSet":
        return DocSet(ids=self.ids[idx], weights=self.weights[idx])

    def to(self, device) -> "DocSet":
        dev = resolve_device(device)
        return DocSet(ids=self.ids.to(dev), weights=self.weights.to(dev))


def make_docset(ids: np.ndarray, weights: np.ndarray, *, device=None) -> DocSet:
    """Build a DocSet from padded numpy arrays, renormalizing weights to L1=1."""
    dev = resolve_device(device)
    ids = np.asarray(ids, dtype=np.int32)
    weights = np.asarray(weights, dtype=np.float32)
    if ids.shape != weights.shape:
        raise ValueError(f"ids {ids.shape} != weights {weights.shape}")
    # Zero out weights at padding (id < 0 convention from ingest) then clamp ids.
    weights = np.where(ids >= 0, weights, 0.0)
    ids = np.maximum(ids, 0)
    norm = weights.sum(axis=-1, keepdims=True)
    norm = np.where(norm > 0, norm, 1.0)
    weights = (weights / norm).astype(np.float32)
    return DocSet(ids=torch.from_numpy(ids).to(dev),
                  weights=torch.from_numpy(weights).to(dev))


def docset_from_lists(docs: list[list[Tuple[int, float]]], h_max: int,
                      *, device=None) -> DocSet:
    """Build a DocSet from per-doc (word_id, count) lists, truncating to h_max."""
    n = len(docs)
    ids = np.full((n, h_max), -1, dtype=np.int32)
    w = np.zeros((n, h_max), dtype=np.float32)
    for i, doc in enumerate(docs):
        # Keep the h_max heaviest terms.
        doc = sorted(doc, key=lambda t: -t[1])[:h_max]
        for p, (wid, cnt) in enumerate(doc):
            ids[i, p] = wid
            w[i, p] = cnt
    return make_docset(ids, w, device=device)


def to_csr(ds: DocSet, vocab_size: int):
    """Host-side CSR view (indptr, indices, data) as numpy arrays."""
    ids = ds.ids.cpu().numpy()
    w = ds.weights.cpu().numpy()
    mask = w > 0
    counts = mask.sum(axis=1)
    indptr = np.zeros(ids.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indices = ids[mask].astype(np.int64)
    data = w[mask].astype(np.float32)
    if indices.size and indices.max() >= vocab_size:
        raise ValueError("word id exceeds vocab_size")
    return indptr, indices, data


def from_csr(indptr, indices, data, h_max: int, *, device=None) -> DocSet:
    """Inverse of :func:`to_csr` (pads/truncates rows to ``h_max``)."""
    n = len(indptr) - 1
    ids = np.full((n, h_max), -1, dtype=np.int32)
    w = np.zeros((n, h_max), dtype=np.float32)
    for i in range(n):
        lo, hi = int(indptr[i]), int(indptr[i + 1])
        row_ids = indices[lo:hi]
        row_w = data[lo:hi]
        if hi - lo > h_max:
            order = np.argsort(-row_w)[:h_max]
            row_ids, row_w = row_ids[order], row_w[order]
        ids[i, : len(row_ids)] = row_ids
        w[i, : len(row_w)] = row_w
    return make_docset(ids, w, device=device)
