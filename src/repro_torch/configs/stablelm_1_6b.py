"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32 = MHA)
d_ff=5632, vocab=100352.  [hf:stabilityai/stablelm-2-1_6b]  The port's
copy of ``repro.configs.stablelm_1_6b``.
"""

import dataclasses

import torch

from repro_torch.configs.cells import lm_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="stablelm-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
)

REDUCED = TransformerConfig(
    name="stablelm-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    dtype=torch.float32,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="stablelm-1.6b",
        family="lm",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: lm_cell("stablelm-1.6b", FULL, s),
        make_probe_cell=lambda s, t: lm_cell("stablelm-1.6b", dataclasses.replace(FULL, n_layers=t), s),
        source="hf:stabilityai/stablelm-2-1_6b; unverified",
    )
