"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408,
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B]  The port's copy of
``repro.configs.moonshot_v1_16b_a3b``: the port's ``Transformer`` serves
it (the MoE FFN by index, GQA attention on B6 at head dim 128); its
train and dry-run cells are not ported (``make_cell`` raises naming
ROADMAP A.9.4-A.9.5).
"""

import torch

from repro_torch.configs.registry import ArchSpec, cell_not_ported
from repro_torch.models.transformer import MoEConfig, TransformerConfig

FULL = TransformerConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab=163840,
    d_head=128,
    moe=MoEConfig(
        num_experts=64, top_k=6, d_ff_expert=1408, capacity_factor=1.0, group_size=256
    ),
)

REDUCED = TransformerConfig(
    name="moonshot-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=128,
    d_head=16,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32),
    dtype=torch.float32,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="moonshot-v1-16b-a3b",
        family="lm",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=cell_not_ported("moonshot-v1-16b-a3b"),
        make_probe_cell=cell_not_ported("moonshot-v1-16b-a3b"),
        source="hf:moonshotai/Moonlight-16B-A3B; hf",
    )
