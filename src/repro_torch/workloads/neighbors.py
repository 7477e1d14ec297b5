"""Near-duplicate gating for ingest (part of the counterpart of
``repro.workloads.neighbors``).

Only what the corpus manager's ingest gate calls is here: the noise floor
of an exact copy's score, its clamp, and :func:`ingest_dedup_mask`.  The
threshold is in symmetric LC-RWMD units — a LOWER bound on WMD, so every
true WMD near-duplicate at the same threshold is caught (no false admits).
"""

from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.lc_rwmd import lc_rwmd_symmetric

#: Numeric noise floor of the symmetric LC-RWMD score for EXACT copies.
#: Phase-1 distances come from the matmul form ``||a||² + ||b||² − 2ab``
#: whose cancellation error survives the sqrt, so identical docs score
#: ~7e-4 — NOT 0.  Thresholds below this floor silently miss exact
#: duplicates; :func:`ingest_dedup_mask` clamps up to it (with a warning)
#: instead of failing silently.
DUPLICATE_SCORE_FLOOR: float = 1e-2


def _floor_threshold(threshold: float, caller: str) -> float:
    """Validate/clamp a near-duplicate threshold against the noise floor."""
    if not threshold > 0.0:
        raise ValueError(
            f"{caller}: threshold must be > 0, got {threshold!r}")
    if threshold < DUPLICATE_SCORE_FLOOR:
        warnings.warn(
            f"{caller}: threshold {threshold:g} is below the symmetric "
            f"LC-RWMD numeric noise floor ({DUPLICATE_SCORE_FLOOR:g}); "
            f"exact duplicates score ~7e-4, not 0, so this threshold would "
            f"silently miss them.  Clamping to {DUPLICATE_SCORE_FLOOR:g}.",
            stacklevel=3)
        return DUPLICATE_SCORE_FLOOR
    return threshold


def ingest_dedup_mask(engine, docs, threshold: float, *,
                      intra_batch: bool = True) -> np.ndarray:
    """(B,) bool gate for ingest: True where a doc is NOT a near-duplicate.

    Each incoming doc is scored by symmetric LC-RWMD against the engine's
    live corpus (``engine.symmetric``: an (n, B) matrix, tombstoned rows
    +inf, so a deleted doc can't block an ingest; on the card phase 1, the
    ELL SpMM and the d21 mode), reduced to its column minima on the
    engine's device, and docs within ``threshold`` of an existing doc are
    dropped.  ``intra_batch=True`` also de-dups WITHIN the batch (first
    occurrence wins).  Thresholds below :data:`DUPLICATE_SCORE_FLOOR` are
    clamped up to it with a warning.
    """
    threshold = _floor_threshold(threshold, "ingest_dedup_mask")
    b = docs.n_docs
    keep = np.ones(b, dtype=bool)
    docs = docs.to(engine.device)
    if engine.n_live:
        d_min = engine.symmetric(docs).amin(dim=0)           # (B,)
        keep &= d_min.cpu().numpy() > threshold
    if intra_batch and b > 1:
        dd = lc_rwmd_symmetric(docs, docs, engine.emb_full).cpu().numpy()
        for j in range(1, b):
            if keep[j] and bool((dd[:j, j][keep[:j]] <= threshold).any()):
                keep[j] = False
    return keep


__all__ = ["DUPLICATE_SCORE_FLOOR", "ingest_dedup_mask"]
