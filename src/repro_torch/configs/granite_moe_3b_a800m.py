"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512,
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
The port's copy of ``repro.configs.granite_moe_3b_a800m``: the port's
``Transformer`` serves it (the MoE FFN by index, GQA attention on B6);
its train and dry-run cells are not ported (``make_cell`` raises naming
ROADMAP A.9.4-A.9.5).

The assignment header says "MoE 40e top-8" while its trailing comment
says 32 experts; the explicit field (40 experts) is implemented.
"""

import os

import torch

from repro_torch.configs.registry import ArchSpec, cell_not_ported
from repro_torch.models.transformer import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=0,
    vocab=49155,
    # the reference's A/B switches: dispatch-group size, capacity, padding
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_ff_expert=512,
        capacity_factor=float(os.environ.get("REPRO_MOE_CAPACITY", "1.0")),
        group_size=int(os.environ.get("REPRO_MOE_GROUP", "256")),
        pad_experts_to=int(os.environ.get("REPRO_MOE_PAD", "48")),
    ),
)

REDUCED = TransformerConfig(
    name="granite-moe-3b-a800m-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
    dtype=torch.float32,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="granite-moe-3b-a800m",
        family="lm",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=cell_not_ported("granite-moe-3b-a800m"),
        make_probe_cell=cell_not_ported("granite-moe-3b-a800m"),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    )
