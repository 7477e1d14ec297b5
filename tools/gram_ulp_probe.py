"""How far one ulp of the plain distance GEMM moves a symmetric top-k.

The CPU's plain folds compute squared distances in the gram form
``|a|^2 + |b|^2 - 2 a.b``, clamped at 0, then take a square root.  Near a
self-match the product cancels the norms, so one ulp of ``a.b`` can move a
distance by far more than an ulp.  This probe runs
``tests/test_torch_corpus_manager.py``'s corpus (256 docs, h_max 16, seed
9) as that test's two-segment engine (docs 0-63, a delta of docs 200-215,
docs 3 and 70 deleted) and asks ``topk`` (k 4) for queries 0-7 three
times: with the GEMM as it is, and with every product nudged one ulp down
and one ulp up.  It prints the largest move of a top-4 distance.

    PYTHONPATH=src python tools/gram_ulp_probe.py     # the CPU, ~2 s
"""

from __future__ import annotations

import torch

from repro_torch.core import lc_rwmd as tlc
from repro_torch.data.synth import CorpusSpec, make_corpus

SPEC = CorpusSpec(n_docs=256, vocab_size=512, emb_dim=48, h_max=16,
                  mean_h=8.0, n_classes=4, seed=9)


def nudged_sq_dists(direction: int):
    """``sq_dists`` with every product moved one ulp (0: unchanged)."""
    def sq_dists(a, b, *, bf16_matmul=False):
        a2 = (a * a).sum(dim=-1)[:, None]
        b2 = (b * b).sum(dim=-1)[None, :]
        ab = a @ b.T
        if direction:
            ab = torch.nextafter(ab, torch.full_like(ab, direction * 1e30))
        return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)
    return sq_dists


def main() -> None:
    c = make_corpus(SPEC, device="cpu")
    docs, emb = c.docs, c.emb
    orig = tlc.sq_dists
    out = {}
    try:
        for direction in (0, -1, 1):
            tlc.sq_dists = nudged_sq_dists(direction)
            eng = tlc.SegmentedEngine(docs[:64], emb, device="cpu")
            eng.append(docs[200:216])
            eng.delete([3, 70])
            out[direction] = eng.topk(docs[:8], 4).dists
    finally:
        tlc.sq_dists = orig
    for direction in (-1, 1):
        move = float((out[direction] - out[0]).abs().max())
        print(f"one ulp {'down' if direction < 0 else 'up'}: largest move of "
              f"a top-4 distance {move:.3e}")


if __name__ == "__main__":
    main()
