"""dimenet [gnn] — 6 blocks, d_hidden=128, n_bilinear=8, n_spherical=7,
n_radial=6; triplet-gather regime.  [arXiv:2003.03123]  The port's copy of
``repro.configs.dimenet``.
"""

from repro_torch.configs.cells import gnn_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.gnn import DimeNetConfig

FULL = DimeNetConfig(
    name="dimenet", n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6
)
REDUCED = DimeNetConfig(
    name="dimenet-smoke", n_blocks=2, d_hidden=32, n_bilinear=4, n_spherical=3, n_radial=3
)
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="dimenet",
        family="gnn",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: gnn_cell("dimenet", FULL, s),
        source="arXiv:2003.03123; unverified",
    )
