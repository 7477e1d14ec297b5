"""The port's mesh program on 8 gloo ranks on the CPU: the rank program of
``tests/test_torch_mesh.py``, which spawns :func:`rank_main`.  Torch only:
it imports neither JAX nor the reference package.  By hand:

    PYTHONPATH=src python tests/torch_mesh_ranks.py INPUTS.npz OUT_DIR

``INPUTS.npz`` holds the corpus (``ids``, ``weights``, ``emb``), the query
count ``b``, ``k`` and the monolithic step's ``row_block``.  The eight
ranks (``torch.multiprocessing`` spawn) meet through a file under
``OUT_DIR`` (no TCP port) and each writes ``OUT_DIR/rank{r}.npz``: for
every mesh and ``phase1_full_mesh`` its engine-less step's TopK and
``d_local``, its all-pairs D1 block and the block's global rows, the
monolithic steps' TopKs and gauges, and what the refusals raised.

:class:`RankAlone` runs one rank of a (1, model) mesh by itself, for the
card's checks of each vocabulary shard's kernel work.
"""

from __future__ import annotations

import datetime
import os
import sys
import traceback
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch.mesh import Mesh

WORLD = 8
# (data, model, pod) as in tests/dist_check.py
MESHES = {"d4m2": (4, 2, None), "p2d2m2": (2, 2, 2), "d1m8": (1, 8, None),
          "d8m1": (8, 1, None)}
MONO = ("p2d2m2", "d1m8")        # the monolithic step at both full-mesh modes
COUNTED = ("d1m8", "d8m1")       # the collective gauges
TIMEOUT = datetime.timedelta(seconds=120)


class RankAlone:
    """Rank ``rank`` of a (1, ``model``) mesh, run alone in this process.

    Its collectives are the identity: a serve step built on it computes
    that rank's shard of the work, and its ``d_local`` is the rank's
    partial D before the psum over model.
    """

    def __init__(self, model: int, rank: int, device):
        self.shape = {"data": 1, "model": model}
        self.axis_names = tuple(self.shape)
        self.coords = {"data": 0, "model": rank}
        self.size = model
        self.device = torch.device(device)
        self.counts: Counter = Counter()

    index_over = Mesh.index_over
    size_over = Mesh.size_over

    def psum(self, x, axes):
        return x

    def all_gather(self, x, axes, dim=0):
        return x


def _mono_runs(mesh, engine, queries, qids, k, row_block, fm, out, tag):
    from repro_torch.distributed.lcrwmd_dist import build_serve_step

    kw = dict(k=k, bf16_matmul=False, phase1_full_mesh=fm, engine=engine,
              row_block=row_block, self_exclude=True)
    for psb in (1, 8):
        res = build_serve_step(mesh, streaming=True, psum_batch=psb, **kw)(
            queries, query_ids=qids)
        out[f"{tag}/stream{psb}/d"] = res.topk.dists.numpy()
        out[f"{tag}/stream{psb}/i"] = res.topk.indices.numpy()
    res = build_serve_step(mesh, streaming=False, **kw)(queries,
                                                        query_ids=qids)
    out[f"{tag}/dense/d"] = res.topk.dists.numpy()
    out[f"{tag}/dense/i"] = res.topk.indices.numpy()
    out[f"{tag}/dense/d_local"] = res.d_local.numpy()


def _gauges(mesh, engine, queries, k, row_block, fm, out, tag):
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.obs import Observability

    for psb in (1, 8):
        obs = Observability()
        build_serve_step(mesh, k=k, bf16_matmul=False, engine=engine,
                         phase1_full_mesh=fm, row_block=row_block,
                         psum_batch=psb, obs=obs)(queries)
        snap = obs.metrics.snapshot()
        for name in ("psum", "all_gather"):
            (series,) = snap[f"serve_step_collectives_{name}"]["series"]
            out[f"{tag}/count{psb}/{name}"] = np.array(series["value"])


def _refusals(mesh, docs, emb, out):
    from repro_torch.core.lc_rwmd import SegmentedEngine
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.launch.mesh import make_host_mesh

    seg = SegmentedEngine(docs, emb, device="cpu")
    for name, kw in (("segmented", dict(engine=seg)),
                     ("routed", dict(engine=seg, index=object()))):
        try:
            build_serve_step(mesh, k=3, **kw)
            out[f"raise/{name}"] = np.array("nothing")
        except NotImplementedError as e:
            out[f"raise/{name}"] = np.array(f"NotImplementedError: {e}")
    for name, shape in (("smaller", (2, 2)), ("larger", (4, 4))):
        try:
            make_host_mesh(*shape, device="cpu")
            out[f"raise/{name}"] = np.array("nothing")
        except ValueError as e:
            out[f"raise/{name}"] = np.array(f"ValueError: {e}")


def rank_main(rank: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
        rank=rank, world_size=WORLD, timeout=TIMEOUT)
    try:
        from repro_torch.core.lc_rwmd import LCRWMDEngine
        from repro_torch.data.docs import DocSet
        from repro_torch.distributed.lcrwmd_dist import (
            build_allpairs_d1, build_serve_step, local_rows)
        from repro_torch.launch.mesh import make_host_mesh

        data = np.load(inputs)
        docs = DocSet(ids=torch.tensor(data["ids"]),
                      weights=torch.tensor(data["weights"]))
        emb = torch.tensor(data["emb"])
        b, k, row_block = (int(data[x]) for x in ("b", "k", "row_block"))
        queries = docs[:b]
        qids = torch.arange(b, dtype=torch.int32)
        engine = LCRWMDEngine(docs, emb, device="cpu")
        out: dict = {}
        for name, (da, mo, po) in MESHES.items():
            mesh = make_host_mesh(da, mo, po, device="cpu")
            out[f"{name}/rows"] = np.array(local_rows(mesh, docs.n_docs))
            out[f"{name}/coords"] = np.array(
                [mesh.coords.get(a, 0) for a in ("pod", "data", "model")])
            for fm in (False, True):
                tag = f"{name}/fm{int(fm)}"
                res = build_serve_step(mesh, k=k, bf16_matmul=False,
                                       phase1_full_mesh=fm)(docs, queries, emb)
                out[f"{tag}/el/d"] = res.topk.dists.numpy()
                out[f"{tag}/el/i"] = res.topk.indices.numpy()
                out[f"{tag}/el/d_local"] = res.d_local.numpy()
                out[f"{tag}/d1"] = build_allpairs_d1(
                    mesh, bf16_matmul=False, phase1_full_mesh=fm)(
                        docs, queries, emb).numpy()
                if name in MONO:
                    _mono_runs(mesh, engine, queries, qids, k, row_block, fm,
                               out, tag)
                if name in COUNTED:
                    _gauges(mesh, engine, queries, k, row_block, fm, out, tag)
        _refusals(mesh, docs, emb, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(argv) -> int:
    inputs, out_dir = argv
    mp.spawn(rank_main, args=(inputs, out_dir), nprocs=WORLD, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
