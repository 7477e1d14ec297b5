"""Config registry: ArchSpec (model cfg + smoke cfg + shape cells).

The port's own copy of the reference's registry, for its LM architectures.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""
    name: str
    kind: str          # train | prefill | decode | serve_logits | retrieval
                       # | gnn_train | lcrwmd_serve | lcrwmd_allpairs
    params: dict       # shape numbers (seq_len, batch, n_nodes, ...)
    exec_overrides: dict = dataclasses.field(default_factory=dict)
    skip_reason: str = ""   # non-empty -> cell is skipped (documented)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str        # lm | gnn | recsys | lcrwmd
    model_cfg: Any
    smoke_cfg: Any     # reduced same-family config for CPU smoke tests
    shapes: dict[str, ShapeCell]
    notes: str = ""


_REGISTRY: dict[str, Any] = {}


def _norm(name: str) -> str:
    return name.replace("_", "").replace("-", "").replace(".", "").lower()


def register(fn):
    """Decorator: module-level ``spec()`` factories register lazily.

    Keys are normalized (dots/dashes/underscores stripped) so function names
    like ``qwen2_5_14b`` resolve ``--arch qwen2.5-14b``.
    """
    _REGISTRY[_norm(fn.__name__)] = fn
    return fn


def get_spec(arch_id: str) -> ArchSpec:
    key = _norm(arch_id)
    if key not in _REGISTRY:
        # import side-effect registration
        import repro_torch.configs  # noqa: F401
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[key]()


# Shared LM shape-cell factory (the 4 assigned LM shapes).
def lm_shapes(
    *,
    train_micro: int,
    prefill_chunk: int = 1024,
    max_decode_len_32k: int = 32768,
    long_seq: int = 524288,
    long_skip: str = "",
) -> dict[str, ShapeCell]:
    cells = {
        "train_4k": ShapeCell(
            "train_4k", "train",
            dict(seq_len=4096, global_batch=256),
            exec_overrides=dict(n_microbatches=train_micro),
        ),
        "prefill_32k": ShapeCell(
            "prefill_32k", "prefill",
            dict(seq_len=32768, global_batch=32),
            exec_overrides=dict(attn_chunk=prefill_chunk),
        ),
        "decode_32k": ShapeCell(
            "decode_32k", "decode",
            dict(seq_len=max_decode_len_32k, global_batch=128),
        ),
        "long_500k": ShapeCell(
            "long_500k", "decode",
            dict(seq_len=long_seq, global_batch=1, context_parallel=True),
            skip_reason=long_skip,
        ),
    }
    return cells

