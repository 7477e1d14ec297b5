"""NequIP arch + its four assigned shape cells.

A copy of the reference's ``configs/gnn_archs.py`` as data.  The port
serves all four cells on the card (energies, and forces where the cell
says); their training steps wait for the port's optimizer.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchSpec, ShapeCell, register
from repro_torch.models.gnn.nequip import NequIPConfig


@register
def nequip() -> ArchSpec:
    """[arXiv:2101.03164] 5 layers, 32 channels, l_max=2, 8 RBF, cutoff 5."""
    cfg = NequIPConfig(
        name="nequip", n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0,
    )
    smoke = NequIPConfig(
        name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2, n_rbf=4,
        cutoff=5.0,
    )
    shapes = {
        # Cora-shaped full batch: continuous 1433-dim node features.
        "full_graph_sm": ShapeCell(
            "full_graph_sm", "gnn_train",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_graphs=1,
                 forces=True)),
        # Reddit-shaped sampled training: 1024 seeds, fanout 15-10 (padded).
        "minibatch_lg": ShapeCell(
            "minibatch_lg", "gnn_train",
            dict(n_nodes=180224, n_edges=184320, d_feat=602, n_graphs=1,
                 forces=True, sampled=True, batch_nodes=1024,
                 fanout=(15, 10))),
        # ogbn-products full batch: 2.45M nodes / 61.9M edges.
        "ogb_products": ShapeCell(
            "ogb_products", "gnn_train",
            dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_graphs=1,
                 forces=False),  # energy-only: force loss doubles the 61M-edge
                                 # backward; documented in DESIGN.md §5
        ),
        # 128 molecules x 30 atoms / 64 edges, species-typed, forces on.
        "molecule": ShapeCell(
            "molecule", "gnn_train",
            dict(n_nodes=3840, n_edges=8192, d_feat=0, n_graphs=128,
                 forces=True)),
    }
    return ArchSpec(
        arch_id="nequip", family="gnn", model_cfg=cfg, smoke_cfg=smoke,
        shapes=shapes,
        notes="Graph shapes are contracts from the assignment (Cora/Reddit/"
              "ogbn-products), not physics claims; NequIP's exact layer "
              "hyperparameters are preserved and continuous node features "
              "embed into the scalar irrep channels (DESIGN.md §5).",
    )
