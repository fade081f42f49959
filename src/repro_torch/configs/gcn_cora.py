"""gcn-cora [gnn] — 2 layers, d_hidden=16, sym-norm aggregator.
[arXiv:1609.02907]  The port's copy of ``repro.configs.gcn_cora``.
"""

from repro_torch.configs.cells import gnn_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.gnn import GCNConfig

FULL = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, d_feat=1433, n_classes=7)
REDUCED = GCNConfig(name="gcn-smoke", n_layers=2, d_hidden=8, d_feat=32, n_classes=4)
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="gcn-cora",
        family="gnn",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: gnn_cell("gcn-cora", FULL, s),
        source="arXiv:1609.02907; paper",
    )
