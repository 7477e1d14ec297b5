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
monolithic steps' TopKs and gauges, and what the refusals raised.  Then
the corpus's first ``SEGMENTS[-1][1]`` docs as a segmented engine of
three segments with tombstones, a cluster index over it, and the
segmented and routed steps (self-excluding) of ``SEG_RUNS`` and
``ROUTED_RUNS`` with the one-device steps beside them, each called at
every one of ``VERSIONS`` (a delete, an append and a compact made alike on
every rank between them); their gauges; a ``QueryServer`` on (8, 1)
whose deadline ``LAPSED`` lapses on rank 0 only; and an
``AsyncQueryServer`` on ``ASYNC_MESH`` fed raw payloads through an ingest
pool of one worker a rank (``ASYNC_STREAM``: a deadline that lapses on
rank 0 only, one that rank 0's admission check rejects, a mid-stream
ingest and delete, a planned worker crash and a payload that one rank
vectorizes differently).

:class:`RankAlone` runs one rank of a (data, model) mesh by itself, for
the card's checks of each shard's kernel work.
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

# The segmented engine and its index: three segments, the index, tombstones
# (query 2's own doc among them), then a delete, an append and a compact.
SEGMENTS = ((0, 36), (36, 46), (46, 56))
APPEND = (56, 64)
DEAD = ((2, 5, 38, 50), (10, 20, 47))
CELLS = dict(num_cells=16, top_p=3, probe_cap=16, seed=0)
VERSIONS = ("v0", "delete", "append", "compact")
SEG_RUNS = (("p2d2m2", 0), ("p2d2m2", 1), ("d8m1", 0), ("d8m1", 1))
ROUTED_RUNS = (("d1m8", 0), ("d1m8", 1), ("d4m2", 0), ("d4m2", 1),
               ("d8m1", 0))
# The server on (8, 1): batches of SERVER_BATCH, the deadline of query
# LAPSED (LAPSE_S) lapses on rank 0 only; degradation steps the tier down
# on the miss and back up after RECOVER_AFTER batches.
SERVER_PICKS = (3, 17, 41, 8, 60, 29, 33, 12, 50, 1)
SERVER_BATCH = 4
LAPSED = 1
LAPSE_S = 1e-3
RECOVER_AFTER = 2
# The async server on ASYNC_MESH: its corpus is docs [0, ASYNC_BASE), the
# rest ingested and ASYNC_DEAD deleted mid-stream (while part B is
# queued); parts A, B and C of ASYNC_PART payloads each (seeds of
# _ingest_vectorizers.SeededHistogramVectorizer), each part drained.
# Batch 0 sleeps ASYNC_SLEEP_S, so the deadline of payload ASYNC_LAPSED
# (ASYNC_LAPSE_S, rank 0 only) lapses while it is queued; rank 0 submits
# payload ASYNC_REJECTED with an expired deadline; batch ASYNC_CRASH
# crashes the worker; rank ASYNC_ODD_RANK submits another payload at
# ASYNC_ODD.  No part fills the queue to the shed depth, so only the lapse
# and the crash step the tier down.
ASYNC_MESH = "d4m2"
ASYNC_BASE = 56
ASYNC_DEAD = (3, 40, 57)
ASYNC_BATCH = 4
ASYNC_WAIT_S = 0.005
ASYNC_PART = 16
ASYNC_SEED = 1000
ASYNC_SLEEP_S = 0.3
ASYNC_LAPSED = 4
ASYNC_LAPSE_S = 0.05
ASYNC_REJECTED = 9
ASYNC_CRASH = 6
ASYNC_ODD = 2 * ASYNC_PART + 5
ASYNC_ODD_RANK = 5
# the stats every rank must hold alike
ASYNC_STATS = ("queries", "batches", "degraded_batches", "deadline_misses",
               "worker_restarts", "validation_failures", "corpus_switches",
               "ewma_latency_s")


class RankAlone:
    """Rank ``rank`` of a (``data``, ``model``) mesh, run alone in this
    process (ranks row-major, model fastest).

    Its collectives are the identity: a serve step built on it computes
    that rank's shard of the work; its ``d_local`` is the rank's partial D
    before the psum over model, and its TopK the rank's own candidates.
    """

    def __init__(self, model: int, rank: int, device, data: int = 1):
        self.shape = {"data": data, "model": model}
        self.axis_names = tuple(self.shape)
        self.coords = {"data": rank // model, "model": rank % model}
        self.size = data * model
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
    from repro_torch.index import ClusterIndex
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving.query_server import AsyncQueryServer, ServerConfig

    seg = SegmentedEngine(docs, emb, device="cpu")
    for name, kw in (("segmented", dict(engine=seg)),
                     ("routed", dict(engine=seg, index=ClusterIndex(
                         seg, num_cells=4, seed=0)))):
        try:
            build_serve_step(mesh, k=3, **kw)
            out[f"raise/{name}"] = np.array("nothing")
        except NotImplementedError as e:
            out[f"raise/{name}"] = np.array(f"NotImplementedError: {e}")
    try:   # builds over more than one rank, and closes alike
        AsyncQueryServer(docs, emb, ServerConfig(device="cpu"),
                         mesh=mesh).close()
        out["raise/async"] = np.array("nothing")
    except Exception as e:
        out["raise/async"] = np.array(f"{type(e).__name__}: {e}")
    for name, shape in (("smaller", (2, 2)), ("larger", (4, 4))):
        try:
            make_host_mesh(*shape, device="cpu")
            out[f"raise/{name}"] = np.array("nothing")
        except ValueError as e:
            out[f"raise/{name}"] = np.array(f"ValueError: {e}")


def _lifecycle(meshes, docs, emb, queries, qids, k, row_block, out):
    """The segmented and routed steps of ``SEG_RUNS`` / ``ROUTED_RUNS`` and
    the one-device steps, each ONE callable served at every version; the
    route of every version; the seg and routed gauges at ``COUNTED``."""
    from repro_torch.core.lc_rwmd import SegmentedEngine
    from repro_torch.data.docs import DocSet
    from repro_torch.distributed.lcrwmd_dist import build_serve_step
    from repro_torch.index import ClusterIndex
    from repro_torch.obs import Observability

    eng = SegmentedEngine(docs[slice(*SEGMENTS[0])], emb, device="cpu")
    for lo, hi in SEGMENTS[1:]:
        eng.append(docs[lo:hi])
    idx = ClusterIndex(eng, **CELLS)
    eng.delete(list(DEAD[0]))        # honoured by the index without a call
    kw = dict(k=k, bf16_matmul=False, self_exclude=True, row_block=row_block)
    steps = {"seg/one": build_serve_step(engine=eng, **kw),
             "routed/one": build_serve_step(engine=eng, index=idx, **kw)}
    for name, fm in SEG_RUNS:
        steps[f"seg/{name}/fm{fm}"] = build_serve_step(
            meshes[name], engine=eng, phase1_full_mesh=bool(fm), **kw)
    for name, fm in ROUTED_RUNS:
        steps[f"routed/{name}/fm{fm}"] = build_serve_step(
            meshes[name], engine=eng, index=idx, phase1_full_mesh=bool(fm),
            **kw)
    for ver in VERSIONS:
        if ver == "delete":
            eng.delete(list(DEAD[1]))
        elif ver == "append":
            ext = docs[slice(*APPEND)]
            idx.add(eng.append(ext), ext)
        elif ver == "compact":
            eng.compact()
            idx.rebuild()
        for tag, step in steps.items():
            tk = step(queries, qids).topk
            out[f"{tag}/{ver}/d"] = tk.dists.numpy()
            out[f"{tag}/{ver}/i"] = tk.indices.numpy()
        route = idx.route(queries)
        out[f"route/{ver}/cells"] = route.cells
        out[f"route/{ver}/keep"] = route.keep
        out[f"route/{ver}/rows"] = np.array(
            [0 if c is None else c.segment.n_rows for c in idx.cells])
        out[f"segments/{ver}"] = np.array([g.n_rows for g in eng.segments])
    for name in COUNTED:
        for fm in (0, 1):
            for variant, extra in (("seg", {}), ("routed", dict(index=idx))):
                obs = Observability()
                build_serve_step(meshes[name], engine=eng, obs=obs,
                                 phase1_full_mesh=bool(fm), **extra, **kw)(
                    queries, qids)
                snap = obs.metrics.snapshot()
                for what in ("psum", "all_gather"):
                    (series,) = snap[f"serve_step_collectives_{what}"][
                        "series"]
                    assert series["labels"] == {"variant": variant}
                    out[f"gauge/{variant}/{name}/fm{fm}/{what}"] = np.array(
                        series["value"])


def _answers(answers, k):
    """A server's answers as arrays: ids (-1 rows for an error), dists,
    tiers (-1 for an error) and the error types."""
    n = len(answers)
    ids, d = np.full((n, k), -1, np.int64), np.full((n, k), np.inf, np.float32)
    tier, err = np.full(n, -1), []
    for j, a in enumerate(answers):
        if isinstance(a, Exception):
            err.append(type(a).__name__)
            continue
        err.append("")
        ids[j], d[j], tier[j] = a[0], a[1], a.tier
    return ids, d, tier, np.array(err)


def _server(mesh, docs, emb, k, rank, out):
    """A QueryServer on ``mesh``: one flush of ``SERVER_PICKS`` whose query
    ``LAPSED`` has a deadline only rank 0 lets lapse, then the same stream
    through ``serve_stream``."""
    import time

    from repro_torch.serving.query_server import QueryServer, ServerConfig

    cfg = ServerConfig(k=k, max_batch=SERVER_BATCH, h_max=docs.h_max,
                       degradation=True, recover_after=RECOVER_AFTER,
                       device="cpu")
    server = QueryServer(docs, emb, cfg, mesh=mesh)
    ids, w = docs.ids.numpy(), docs.weights.numpy()
    for j, pick in enumerate(SERVER_PICKS):
        lapse = j == LAPSED and rank == 0
        server.submit(ids[pick], w[pick],
                      deadline=LAPSE_S if lapse else None)
    time.sleep(20 * LAPSE_S)
    runs = {"flush": server.flush(),
            "stream": list(server.serve_stream(
                [(ids[p], w[p]) for p in SERVER_PICKS]))}
    for name, answers in runs.items():
        for key, x in zip(("i", "d", "tier", "err"), _answers(answers, k)):
            out[f"server/{name}/{key}"] = x


def async_stream(rank: int | None = None):
    """The async server's payloads and deadlines, part by part, as rank
    ``rank`` submits them (None: as the reference is fed, no deadline)."""
    parts = []
    for p in range(3):
        part = []
        for j in range(p * ASYNC_PART, (p + 1) * ASYNC_PART):
            payload, deadline = ASYNC_SEED + j, None
            if rank == 0 and j == ASYNC_LAPSED:
                deadline = ASYNC_LAPSE_S
            elif rank == 0 and j == ASYNC_REJECTED:
                deadline = 0.0
            elif rank == ASYNC_ODD_RANK and j == ASYNC_ODD:
                payload += 10_000
            part.append((payload, deadline))
        parts.append(part)
    return parts


def async_config(docs, **kw):
    """The async server's ``ServerConfig`` fields (``kw`` added)."""
    return dict(k=kw.pop("k"), max_batch=ASYNC_BATCH, max_wait_s=ASYNC_WAIT_S,
                h_max=docs.h_max, degradation=True,
                shed_queue_depth=2 * ASYNC_PART, recover_after=RECOVER_AFTER,
                **kw)


def _async_server(mesh, docs, emb, k, rank, out):
    """The AsyncQueryServer over the ranks, fed ``async_stream(rank)``
    through an ingest pool of one worker: each part submitted, part B's
    queue holding the ingest and the delete, each part drained."""
    from _ingest_vectorizers import SeededHistogramVectorizer

    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.query_server import AsyncQueryServer, ServerConfig

    cfg = ServerConfig(**async_config(docs, k=k, ingest_workers=1,
                                      device="cpu"))
    vec = SeededHistogramVectorizer(vocab=emb.shape[0], h_max=docs.h_max)
    plan = FaultPlan(latency_s={0: ASYNC_SLEEP_S},
                     crash_batches=(ASYNC_CRASH,))
    server = AsyncQueryServer(docs[:ASYNC_BASE], emb, cfg, mesh=mesh,
                              preprocess=vec, faults=plan)
    futures = []
    try:
        for p, part in enumerate(async_stream(rank)):
            futures += [server.submit(x, deadline=dl) for x, dl in part]
            if p == 1:
                gids, _ = server.ingest(docs[ASYNC_BASE:])
                out["async/ingested"] = np.asarray(gids)
                out["async/deleted"] = np.array(
                    server.delete_docs(list(ASYNC_DEAD)))
            server.drain()
        stats = server.stats_snapshot()
    finally:
        server.close()
    answers = [f.exception() or f.result() for f in futures]
    for key, x in zip(("i", "d", "tier", "err"), _answers(answers, k)):
        out[f"async/{key}"] = x
    out["async/stats"] = np.array([float(stats[s]) for s in ASYNC_STATS]
                                  + stats["tier_counts"])


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
        meshes = {}
        for name, (da, mo, po) in MESHES.items():
            mesh = meshes[name] = make_host_mesh(da, mo, po, device="cpu")
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
        _lifecycle(meshes, docs, emb, queries, qids, k, row_block, out)
        _server(meshes["d8m1"], docs, emb, k, rank, out)
        _async_server(meshes[ASYNC_MESH], docs, emb, k, rank, out)
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
