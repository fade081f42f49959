"""gat-cora [gnn] — 2 layers, d_hidden=8, 8 heads, attention aggregator.
[arXiv:1710.10903]  The port's copy of ``repro.configs.gat_cora``.
"""

from repro_torch.configs.cells import gnn_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.gnn import GATConfig

FULL = GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8, d_feat=1433, n_classes=7)
REDUCED = GATConfig(name="gat-smoke", n_layers=2, d_hidden=4, n_heads=2, d_feat=32, n_classes=4)
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="gat-cora",
        family="gnn",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: gnn_cell("gat-cora", FULL, s),
        source="arXiv:1710.10903; paper",
    )
