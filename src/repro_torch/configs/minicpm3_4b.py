"""minicpm3-4b [dense] — 62L d_model=2560 40H d_ff=6400 vocab=73448,
multi-head latent attention (MLA).  [hf:openbmb/MiniCPM3-4B]
The port's copy of ``repro.configs.minicpm3_4b``: the port's
``Transformer`` serves it (MLA attention on the plain route, absorbed
with a cache) and trains it (``train_4k``: MLA's naive path, chunks
checkpointed).
"""

import dataclasses
import os

import torch

from repro_torch.configs.cells import lm_cell
from repro_torch.configs.registry import ArchSpec
from repro_torch.models.transformer import MLAConfig, TransformerConfig

FULL = TransformerConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attention="mla",
    mla=MLAConfig(
        q_lora_rank=768, kv_lora_rank=256, d_head_nope=64, d_head_rope=32, d_head_v=64
    ),
    # the reference's A/B switch: REPRO_MLA_ABSORBED=0 selects the naive
    # (decompress-per-step) serving path
    mla_absorbed=os.environ.get("REPRO_MLA_ABSORBED", "1") != "0",
)

REDUCED = TransformerConfig(
    name="minicpm3-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    attention="mla",
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, d_head_nope=16, d_head_rope=8, d_head_v=16),
    dtype=torch.float32,
)

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def spec() -> ArchSpec:
    return ArchSpec(
        arch_id="minicpm3-4b",
        family="lm",
        full_config=FULL,
        reduced_config=REDUCED,
        shapes=SHAPES,
        make_cell=lambda s: lm_cell("minicpm3-4b", FULL, s),
        make_probe_cell=lambda s, t: lm_cell("minicpm3-4b", dataclasses.replace(FULL, n_layers=t), s),
        source="hf:openbmb/MiniCPM3-4B; hf",
    )
