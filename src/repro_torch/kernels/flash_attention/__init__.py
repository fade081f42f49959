from repro_torch.kernels.flash_attention.ops import (
    DECODE_ROWS,
    HEAD_DIMS,
    LAUNCHES,
    REGIMES,
    flash_attention_op,
    gqa_attention_op,
    regime,
)
from repro_torch.kernels.flash_attention.ref import attention_ref, gqa_attention_ref

__all__ = ["DECODE_ROWS", "HEAD_DIMS", "LAUNCHES", "REGIMES", "attention_ref",
           "flash_attention_op", "gqa_attention_op", "gqa_attention_ref", "regime"]
