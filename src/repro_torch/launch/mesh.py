"""Mesh construction on ``torch.distributed`` (counterpart of
``repro.launch.mesh``).

Kept as FUNCTIONS (never module-level constants): importing this module
touches no device and no process group.

Mesh semantics, as in the reference:
  pod   — cross-pod axis.  Only embarrassingly-parallel dims are placed
          here (resident docs, global batch); no per-layer collectives.
  data  — intra-pod batch axis.
  model — vocabulary-parallel axis.

Ranks are laid out row-major over ``(pod, data, model)``: ``model`` varies
fastest.  A mesh holds one process group per line of each axis (the ranks
that differ only in that axis); a collective over an axis of size 1 is
skipped.  On ``"cuda"`` the default group must be NCCL and rank r runs on
``cuda:{local rank}`` (``LOCAL_RANK``, else r modulo the visible cards);
on ``"cpu"`` it must be gloo.  Nothing falls back from one to the other.

The mesh must cover the whole world: the reference's sub-meshes over part
of its devices have no counterpart yet, so a mesh smaller than the world
raises, as one larger than it does.  A mesh of one rank needs no process
group at all.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

POD_AXIS = "pod"
DATA_AXIS = "data"
MODEL_AXIS = "model"

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A ``(pod, data, model)`` mesh over the ranks of the default process
    group (or over this process alone).

    ``shape`` maps axis names to sizes, in layout order; ``device`` is this
    rank's device; ``coords`` its index along each axis.  ``psum`` and
    ``all_gather`` are issued over the named axes' groups, in the order
    given, and each one issued is counted in ``counts`` under the
    reference's primitive name (``psum``, ``all_gather``).
    """

    def __init__(self, shape: dict[str, int], device: torch.device):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = device
        self.size = int(np.prod(list(self.shape.values())))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(grid == self.rank)[0])))
        self.counts: Counter = Counter()
        # One group per line of each axis.  Every rank creates every group,
        # in the same order, as new_group requires.
        self._groups: dict[str, object] = {}
        for i, ax in enumerate(self.axis_names):
            if self.shape[ax] == 1:
                continue
            lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[ax])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[ax] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, rank={self.rank})"

    def index_over(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def size_over(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def _live(self, axes, x: torch.Tensor):
        return [a for a in axes if self.shape[a] > 1] if x.numel() else []

    def _gather(self, x: torch.Tensor, axis: str) -> list[torch.Tensor]:
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=self._groups[axis])
        return parts

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of ``x`` over the ranks of each axis in ``axes``.

        Each axis is one collective: the axis's tensors are gathered and
        added in rank order, so every rank of the line holds the same bits
        whatever the tensor's size.  (A ring all-reduce adds each element
        in an order set by the chunk it falls in, so a sum would depend on
        how the rows were batched into collectives.)
        """
        for a in self._live(axes, x):
            parts = self._gather(x, a)
            x = parts[0]
            for p in parts[1:]:
                x = x + p
            self.counts["psum"] += 1
        return x

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """``x`` of every rank of each axis in ``axes``, concatenated in rank
        order along ``dim`` (the reference's ``tiled=True``).  Every rank's
        ``x`` must have the same shape."""
        for a in self._live(axes, x):
            x = torch.cat(self._gather(x, a), dim=dim)
            self.counts["all_gather"] += 1
        return x


def _device_for(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if dist.is_initialized():
            local = int(os.environ.get("LOCAL_RANK",
                                       dist.get_rank() % torch.cuda.device_count()))
        else:
            local = torch.cuda.current_device()
        dev = torch.device("cuda", local)
    return dev


def _mk(shape: dict[str, int], device) -> Mesh:
    n = int(np.prod(list(shape.values())))
    world = dist.get_world_size() if dist.is_initialized() else 1
    desc = "x".join(str(s) for s in shape.values())
    if n > world:
        raise ValueError(f"requested {desc} > {world} ranks")
    if n < world:
        raise ValueError(
            f"requested {desc} < {world} ranks: a mesh must cover the whole "
            "world (sub-meshes over part of the ranks are not supported)")
    dev = _device_for(device)
    if dist.is_initialized():
        want = _BACKEND.get(dev.type)
        backend = dist.get_backend()
        if want is None or backend != want:
            raise ValueError(f"a {dev.type} mesh needs the {want} backend, "
                             f"the process group is {backend}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    return Mesh(shape, dev)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data, model),
    on the card; the world must have 256 or 512 ranks."""
    if multi_pod:
        return _mk({POD_AXIS: 2, DATA_AXIS: 16, MODEL_AXIS: 16}, None)
    return _mk({DATA_AXIS: 16, MODEL_AXIS: 16}, None)


def make_host_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                   device=None) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with ``pod``, over the
    world's ranks (``device``: ``None`` → the card)."""
    if pod is None:
        return _mk({DATA_AXIS: data, MODEL_AXIS: model}, device)
    return _mk({POD_AXIS: pod, DATA_AXIS: data, MODEL_AXIS: model}, device)


def mesh_axis_names(mesh: Mesh) -> tuple[str, ...]:
    return tuple(mesh.axis_names)


def batch_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes over which batch-like (embarrassingly parallel) dims shard."""
    return tuple(a for a in mesh.axis_names if a in (POD_AXIS, DATA_AXIS))


def n_chips(mesh: Mesh) -> int:
    return mesh.size


__all__ = ["DATA_AXIS", "MODEL_AXIS", "POD_AXIS", "Mesh", "batch_axes",
           "make_host_mesh", "make_production_mesh", "mesh_axis_names",
           "n_chips"]
