"""wide-deep [recsys] — 40 sparse fields, embed_dim=32, MLP 1024-512-256,
concat interaction.  [arXiv:1606.07792]  The port's copy of
``repro.configs.wide_deep``.
"""

from repro_torch.configs.cells import recsys_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.recsys import WideDeepConfig

FULL = WideDeepConfig(
    name="wide-deep",
    n_sparse=40,
    n_dense=13,
    embed_dim=32,
    vocab_per_field=1_000_000,
    mlp_dims=(1024, 512, 256),
)
REDUCED = WideDeepConfig(
    name="wide-deep-smoke",
    n_sparse=8,
    n_dense=4,
    embed_dim=8,
    vocab_per_field=128,
    mlp_dims=(32, 16),
)
SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="wide-deep",
        family="recsys",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: recsys_cell("wide-deep", FULL, s),
        source="arXiv:1606.07792; paper",
    )
