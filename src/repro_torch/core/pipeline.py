"""The WMD pruning cascade (paper Sec. III, "Speeding-up WMD using RWMD").

Given a query, WMD against a huge resident set is made tractable by:

  1. LC-RWMD against ALL resident docs (cheap lower bound, this paper),
  2. candidate selection: the top docs by RWMD get full WMD; the k-th WMD
     value becomes the cut-off L,
  3. every remaining doc with RWMD ≥ L is pruned (RWMD lower-bounds WMD,
     so it provably cannot enter the top-k),
  4. full WMD only on the survivors.

As in the reference, WMD runs on a fixed ``refine_budget`` of the
smallest-RWMD docs, and ``pruned_exact`` certifies per query that the budget
covered every true survivor.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import topk as topk_lib
from repro_torch.core.distances import dists
from repro_torch.core.lc_rwmd import LCRWMDEngine, as_f32, lc_rwmd_symmetric
from repro_torch.core.wcd import centroids_from_t, resident_centroids
from repro_torch.core.wmd import wmd_candidate_values
from repro_torch.data.docs import DocSet


class QualityTier(enum.IntEnum):
    """The serving plane's degradation ladder (the cascade read top-down).

      tier  stage served                                    bound quality
      0     LC-RWMD candidates + Sinkhorn-WMD rerank        exact-style WMD
      1     LC-RWMD candidates served directly              tight lower bound
      2     WCD shortlist (centroid distances)              loose lower bound
    """

    FULL = 0
    LCRWMD = 1
    WCD = 2


def cascade_topk(
    engine: LCRWMDEngine,
    queries: DocSet,
    k: int,
    *,
    tier: QualityTier | int = QualityTier.FULL,
    rerank_budget: int | None = None,
    sinkhorn_kw: dict | None = None,
) -> topk_lib.TopK:
    """Single-host tiered cascade entry: top-k at the requested quality tier.

    Returns a (B, k) :class:`~repro_torch.core.topk.TopK` (ascending,
    global doc ids).  Tier 2's resident centroids are gathered from the
    engine's full table in row chunks (never an (n, h, m) tensor).
    """
    tier = QualityTier(int(tier))
    queries = queries.to(engine.device)
    if tier >= QualityTier.WCD:
        c_r = resident_centroids(engine.resident, engine.emb_full)  # (n, m)
        c_q = centroids_from_t(queries.weights,
                               engine.gather_queries(queries.ids))   # (B, m)
        return topk_lib.topk_smallest_cols(dists(c_r, c_q), k)
    if tier >= QualityTier.LCRWMD:
        return engine.topk_streaming(queries, k)
    budget = min(max(rerank_budget or 2 * k, k), engine.resident.n_docs)
    # Any budget: on the card the fused top-k kernel carries k > 128 in
    # global memory and takes any number of queries.
    cand = engine.topk_streaming(queries, budget)
    return engine.rerank_topk(queries, cand.indices, k,
                              sinkhorn_kw=sinkhorn_kw)


class PrunedWMDResult(NamedTuple):
    topk: topk_lib.TopK       # (B, k) final WMD top-k (distances ascending)
    rwmd_topk: topk_lib.TopK  # (B, k) the RWMD-only top-k (for overlap metrics)
    n_refined: torch.Tensor   # (B,) int32 WMD evaluations spent per query
    pruned_exact: torch.Tensor  # (B,) bool: True → provably equals full WMD
    cutoff: torch.Tensor      # (B,) the cut-off value L


def pruned_wmd_topk(
    resident: DocSet,
    queries: DocSet,
    emb,
    *,
    k: int,
    refine_budget: int | None = None,
    sinkhorn_kw: dict | None = None,
    engine: LCRWMDEngine | None = None,
    use_kernel: bool | None = None,
    index=None,
    top_p: int | None = None,
) -> PrunedWMDResult:
    """Top-k WMD per query via the RWMD pruning cascade.

    ``resident`` (n, h1) / ``queries`` (B, h2) DocSets, ``emb`` (v, m) →
    :class:`PrunedWMDResult`.  ``refine_budget`` defaults to ``min(4·k, n)``
    and is clamped to ``[k, n]``.  ``engine``: a prebuilt
    :class:`LCRWMDEngine` over the SAME resident set and embeddings; stage 1
    then streams the symmetric bound through it (the (n, B) matrix is never
    built), the work runs on the engine's device, and the rerank reads the
    engine's device copies of the resident docs and embeddings (``resident``
    and ``emb`` are not copied again).  Without an engine,
    stage 1 materializes the symmetric matrix on the resident's device.
    ``use_kernel`` routes the WMD refine through the Sinkhorn-WMD kernel
    (True) or the batched solver ``sinkhorn_log_batched`` (False); unset,
    it follows the reference: the kernel with an engine (the port's engine
    is the reference's ``use_kernel=True`` engine), the solver without.

    ``index``: a :class:`repro_torch.index.ClusterIndex` over ``resident``
    — the cell-routing and triangle-bound stage goes before phase 1: the
    queries route to their ``top_p`` nearest cells (the index's default
    when None), the bound drops routed cells that cannot hold a
    competitive match, and stage 1 scans only the surviving cells
    (``index.routed_topk``).  The rerank then reads the index engine's
    device tensors, and ``use_kernel`` unset takes the kernel.
    ``pruned_exact`` certifies exactness relative to the routed cells;
    the budget covering the corpus makes it unconditional only when
    routing kept every cell for every query.
    """
    sinkhorn_kw = sinkhorn_kw or {}
    n = resident.n_docs
    budget = refine_budget or min(4 * k, n)
    budget = min(max(budget, k), n)  # bootstrap needs k candidates
    if use_kernel is None:
        use_kernel = engine is not None or index is not None

    if index is not None:
        route = index.route(queries, top_p=top_p)
        if route.n_docs_pruned and index.obs is not None \
                and index.obs.metrics.enabled:
            index.obs.metrics.counter(
                "cascade_bound_pruned_docs_total",
                "Docs excluded from phase 1 by the cascade's "
                "centroid/triangle bound stage.").inc(route.n_docs_pruned)
        cand = index.routed_topk(queries, budget, route=route)  # (B, budget)
        engine = index.engine
    elif engine is not None:
        # on the card: phase 1, the swapped direction and the fused top-k
        # kernels (no slab; d21 (n, B) is the one extra tensor)
        cand = engine.symmetric_topk_streaming(queries, budget)  # (B, budget)
    if engine is not None:
        queries = queries.to(engine.device)
        flat = torch.clamp(cand.indices, 0, n - 1).reshape(-1).long()
        # The engine's device tensors hold the same values as the caller's
        # resident set and embeddings: nothing is copied to the device.
        t1, w1, t2 = engine.candidate_pairs(flat, queries.ids)
        bf16 = engine.bf16_matmul
    else:
        dev = resident.device
        queries = queries.to(dev)
        d_rwmd = lc_rwmd_symmetric(resident, queries, emb)  # (n, B)
        cand = topk_lib.topk_smallest_cols(d_rwmd, budget)
        emb_t = as_f32(emb, dev)
        flat = torch.clamp(cand.indices, 0, n - 1).reshape(-1).long()
        t1 = emb_t[resident.ids[flat].long()]
        w1 = resident.weights[flat]
        t2 = emb_t[queries.ids.long()]
        bf16 = False

    rwmd_topk = topk_lib.TopK(cand.dists[:, :k], cand.indices[:, :k])
    wmd_vals = wmd_candidate_values(
        t1, w1, t2, queries.weights, use_kernel=use_kernel, bf16_matmul=bf16,
        **sinkhorn_kw,
    )  # (B, budget)
    wmd_vals = torch.where(cand.indices >= 0, wmd_vals,
                           torch.full_like(wmd_vals, float("inf")))

    # Cut-off L = k-th smallest WMD among the first k candidates; docs with
    # RWMD >= L are provably outside the top-k.
    cutoff = wmd_vals[:, :k].amax(dim=1)                     # (B,)
    needed = cand.dists < cutoff[:, None]
    n_refined = (k + needed[:, k:].sum(dim=1)).to(torch.int32)
    exact = cand.dists[:, -1] >= cutoff
    if budget == n and (index is None or (
            route.keep.all() and route.cells.shape[1] == index.num_cells)):
        exact = torch.ones_like(exact)
    topk = topk_lib.topk_from_candidates(wmd_vals, cand.indices, k)
    return PrunedWMDResult(topk=topk, rwmd_topk=rwmd_topk, n_refined=n_refined,
                           pruned_exact=exact, cutoff=cutoff)


def knn_classify(topk: topk_lib.TopK, resident_labels, n_classes: int, *,
                 weights: str = "uniform", eps: float = 1e-6) -> torch.Tensor:
    """kNN labels from a TopK result: (B,) int32.

    ``weights="uniform"`` is the plain majority vote; count ties resolve to
    the LOWEST class id.  ``weights="distance"`` weights each vote by
    ``1/(d + eps)``.
    """
    if not isinstance(resident_labels, torch.Tensor):
        resident_labels = torch.as_tensor(np.asarray(resident_labels))
    labels = resident_labels.to(topk.indices.device)
    votes = labels[topk.indices.long()].long()                 # (B, k)
    onehot = F.one_hot(votes, n_classes).to(torch.float32)
    if weights == "uniform":
        w = torch.ones_like(topk.dists, dtype=torch.float32)
    elif weights == "distance":
        w = 1.0 / (topk.dists.to(torch.float32) + eps)
    else:
        raise ValueError(f"weights must be 'uniform' or 'distance', got {weights!r}")
    return torch.argmax((w[..., None] * onehot).sum(dim=1), dim=-1).to(torch.int32)


@dataclasses.dataclass
class AdaptiveRefineBudget:
    """Grow ``refine_budget`` geometrically from observed pruning failures.

    Feed each batch's ``pruned_exact`` flags to :meth:`update`; while the
    failure rate exceeds ``target_failure_rate``, the budget multiplies by
    ``growth`` (clamped to ``[k, n_resident]``).  ``decay_after`` adds the
    DOWN direction: after that many CONSECUTIVE all-exact batches the budget
    shrinks by ``decay``, never below the largest budget ever observed to
    fail (``failed_budget``), so each level is probed at most once on
    stationary traffic.  ``decay_after=None`` keeps grow-only behaviour.
    """

    k: int
    n_resident: int
    init: int | None = None
    growth: float = 2.0
    target_failure_rate: float = 0.05
    decay_after: int | None = None
    decay: float = 0.5
    #: Optional :class:`repro_torch.obs.Observability` bundle; when set,
    #: each :meth:`update` records pruned-exact/inexact counters and the
    #: current budget gauge.  Excluded from repr/eq: it is plumbing, not
    #: controller state.
    obs: object = dataclasses.field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.k < 1 or self.n_resident < 1:
            raise ValueError("k and n_resident must be positive")
        if self.growth <= 1.0:
            raise ValueError(f"growth must exceed 1, got {self.growth}")
        if not 0.0 < self.decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {self.decay}")
        if self.decay_after is not None and self.decay_after < 1:
            raise ValueError(f"decay_after must be >= 1, got {self.decay_after}")
        start = 4 * self.k if self.init is None else self.init
        self.budget = self._clamp(start)
        self.exact_streak = 0   # consecutive all-exact batches observed
        self.failed_budget = 0  # largest budget observed to fail (decay floor)

    def _clamp(self, b: int) -> int:
        return max(self.k, min(int(b), self.n_resident))

    @property
    def saturated(self) -> bool:
        """True once the budget covers the whole resident set (always exact)."""
        return self.budget >= self.n_resident

    def reset_decay_floor(self) -> None:
        """Forget past failures so decay may re-probe smaller budgets."""
        self.failed_budget = 0

    def on_corpus_change(self, n_resident: int) -> None:
        """Re-anchor the controller after the resident corpus changed."""
        if n_resident < 1:
            raise ValueError(f"n_resident must be positive, got {n_resident}")
        self.n_resident = int(n_resident)
        self.budget = self._clamp(self.budget)
        self.exact_streak = 0
        self.reset_decay_floor()

    def update(self, pruned_exact) -> int:
        """Observe one batch's ``pruned_exact`` flags; return the new budget."""
        if isinstance(pruned_exact, torch.Tensor):
            pruned_exact = pruned_exact.cpu().numpy()
        flags = np.asarray(pruned_exact).astype(bool).reshape(-1)
        if not flags.size:
            return self.budget
        obs = self.obs
        if obs is not None and obs.metrics.enabled:
            n_exact = int(flags.sum())
            m = obs.metrics
            m.counter("cascade_pruned_exact_total",
                      "Queries whose rerank budget provably covered every "
                      "true survivor.").inc(n_exact)
            m.counter("cascade_pruned_inexact_total",
                      "Queries whose pruning was NOT certified exact "
                      "(drives budget growth).").inc(flags.size - n_exact)
        if (1.0 - flags.mean()) > self.target_failure_rate:
            self.failed_budget = max(self.failed_budget, self.budget)
            self.budget = self._clamp(math.ceil(self.budget * self.growth))
            self.exact_streak = 0
        elif flags.all():
            self.exact_streak += 1
            if (self.decay_after is not None
                    and self.exact_streak >= self.decay_after
                    and self.budget > self.k):
                target = self._clamp(math.floor(self.budget * self.decay))
                if target > self.failed_budget:  # never re-probe a known miss
                    self.budget = target
                self.exact_streak = 0
        else:
            self.exact_streak = 0
        if obs is not None and obs.metrics.enabled:
            obs.metrics.gauge(
                "cascade_refine_budget",
                "Current adaptive rerank budget (kc).").set(self.budget)
        return self.budget
