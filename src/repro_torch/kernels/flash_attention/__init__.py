from repro_torch.kernels.flash_attention.ops import (
    HEAD_DIMS,
    LAUNCHES,
    flash_attention_op,
    gqa_attention_op,
)
from repro_torch.kernels.flash_attention.ref import attention_ref, gqa_attention_ref

__all__ = ["HEAD_DIMS", "LAUNCHES", "attention_ref", "flash_attention_op", "gqa_attention_op",
           "gqa_attention_ref"]
