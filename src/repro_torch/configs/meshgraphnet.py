"""meshgraphnet [gnn] — 15 layers, d_hidden=128, sum aggregator,
2-layer MLPs (encode-process-decode).  [arXiv:2010.03409]  The port's copy
of ``repro.configs.meshgraphnet``.
"""

from repro_torch.configs.cells import gnn_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.gnn import MGNConfig

FULL = MGNConfig(
    name="meshgraphnet", n_layers=15, d_hidden=128, mlp_layers=2, d_node_in=8, d_edge_in=4,
    d_out=3,
)
REDUCED = MGNConfig(
    name="mgn-smoke", n_layers=3, d_hidden=32, mlp_layers=2, d_node_in=8, d_edge_in=4, d_out=3
)
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="meshgraphnet",
        family="gnn",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: gnn_cell("meshgraphnet", FULL, s),
        source="arXiv:2010.03409; unverified",
    )
