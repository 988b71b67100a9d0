"""gcn-cora [gnn] n_layers=2 d_hidden=16 aggregator=mean norm=sym
[arXiv:1609.02907; paper] (counterpart of ``repro.configs.gcn_cora``).

The feature/class dims are SHAPE-dependent (each cell is a different
public graph): cora 1433/7, reddit-like minibatch 602/41, ogbn-products
100/47, molecule 32/16.  LSS is inapplicable: the output layer is 7..47
classes wide.
"""

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.gnn import GCNConfig

__all__ = ["CONFIG"]

CONFIG = ArchSpec(
    arch_id="gcn-cora",
    family="gnn",
    model_cfg=GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16,
                        d_feat=1433, n_classes=7),
    shapes={
        "full_graph_sm": ShapeSpec("full_graph_sm", "train", {
            "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
            "n_classes": 7}),
        "minibatch_lg": ShapeSpec("minibatch_lg", "train_sampled", {
            "n_nodes": 232965, "n_edges": 114615892, "batch_nodes": 1024,
            "fanout": (15, 10), "d_feat": 602, "n_classes": 41}),
        "ogb_products": ShapeSpec("ogb_products", "train", {
            "n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
            "n_classes": 47}),
        "molecule": ShapeSpec("molecule", "train_batched", {
            "n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 32,
            "n_classes": 16}),
    },
    lss=None,
    notes="LSS inapplicable (7-47-wide output).",
)
