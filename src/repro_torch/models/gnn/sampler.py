"""Graph utilities: synthetic graph generation + a REAL fanout neighbor
sampler (GraphSAGE-style) for the ``minibatch_lg`` shape cell.

The port's own copy of ``repro.models.gnn.sampler``: host-side numpy
(samplers are data-pipeline work) that gives the reference's arrays for
the same seed.  The subgraphs are padded to fixed sizes, as the cell's
shapes say.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HostGraph:
    """CSR adjacency on the host + node payloads."""
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (nnz,) neighbor ids
    positions: np.ndarray  # (N, 3) f32
    node_feat: np.ndarray | None  # (N, d) f32 or None
    species: np.ndarray   # (N,) int32

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def random_graph(
    n_nodes: int, avg_degree: float, *, d_feat: int = 0, n_species: int = 16,
    seed: int = 0, box: float = 10.0,
) -> HostGraph:
    """Erdos-Renyi-ish random graph with positions in a box (symmetrized)."""
    rng = np.random.default_rng(seed)
    n_edges = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # symmetrize + dedupe
    a = np.concatenate([src, dst])
    b = np.concatenate([dst, src])
    key = a.astype(np.int64) * n_nodes + b
    _, uniq = np.unique(key, return_index=True)
    a, b = a[uniq], b[uniq]
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, a + 1, 1)
    np.cumsum(indptr, out=indptr)
    return HostGraph(
        indptr=indptr,
        indices=b.astype(np.int32),
        positions=(rng.uniform(0, box, (n_nodes, 3))).astype(np.float32),
        node_feat=(rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
                   if d_feat else None),
        species=rng.integers(0, n_species, n_nodes).astype(np.int32),
    )


def sample_fanout_subgraph(
    g: HostGraph, batch_nodes: np.ndarray, fanout: tuple[int, ...],
    *, rng: np.random.Generator, max_nodes: int, max_edges: int,
):
    """k-hop fanout sampling from seed nodes; returns a PADDED subgraph.

    Returns dict with local edge_index (2, max_edges), masks, the local->
    global node map, and seed positions (first len(batch_nodes) local ids).
    """
    nodes = list(batch_nodes)
    node_set = {int(v): i for i, v in enumerate(batch_nodes)}
    edges_src: list[int] = []
    edges_dst: list[int] = []
    frontier = list(batch_nodes)
    for f in fanout:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            neigh = g.indices[lo:hi]
            if len(neigh) > f:
                neigh = rng.choice(neigh, size=f, replace=False)
            for u in neigh:
                u = int(u)
                if u not in node_set:
                    if len(nodes) >= max_nodes:
                        continue
                    node_set[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                if len(edges_src) < max_edges:
                    edges_src.append(node_set[u])   # message u -> v
                    edges_dst.append(node_set[int(v)])
        frontier = nxt
    n, e = len(nodes), len(edges_src)
    nodes_arr = np.asarray(nodes, dtype=np.int64)
    out = {
        "edge_index": np.zeros((2, max_edges), np.int32),
        "edge_mask": np.zeros((max_edges,), bool),
        "node_mask": np.zeros((max_nodes,), bool),
        "local_to_global": np.zeros((max_nodes,), np.int64),
        "positions": np.zeros((max_nodes, 3), np.float32),
        "species": np.zeros((max_nodes,), np.int32),
    }
    out["edge_index"][0, :e] = edges_src
    out["edge_index"][1, :e] = edges_dst
    out["edge_mask"][:e] = True
    out["node_mask"][:n] = True
    out["local_to_global"][:n] = nodes_arr
    out["positions"][:n] = g.positions[nodes_arr]
    out["species"][:n] = g.species[nodes_arr]
    if g.node_feat is not None:
        feat = np.zeros((max_nodes, g.node_feat.shape[1]), np.float32)
        feat[:n] = g.node_feat[nodes_arr]
        out["node_feat"] = feat
    return out
