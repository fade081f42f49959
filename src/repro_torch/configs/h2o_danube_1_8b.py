"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912,
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]  The port's copy of ``repro.configs.h2o_danube_1_8b``.
"""

import dataclasses

import torch

from repro_torch.configs.cells import lm_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import TransformerConfig

FULL = TransformerConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,
)

REDUCED = TransformerConfig(
    name="danube-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    window=16,
    dtype=torch.float32,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="h2o-danube-1.8b",
        family="lm",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: lm_cell("h2o-danube-1.8b", FULL, s),
        make_probe_cell=lambda s, t: lm_cell("h2o-danube-1.8b", dataclasses.replace(FULL, n_layers=t), s),
        source="arXiv:2401.16818; hf",
    )
