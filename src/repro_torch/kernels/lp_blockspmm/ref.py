"""Plain PyTorch version of the fused LP round: ``out = c·base + A @ F``."""

from __future__ import annotations

import torch


def lp_round_ref(
    A: torch.Tensor,  # (N, N) fused operator (αβ·scale·H + α·M)
    F: torch.Tensor,  # (N, S) current labels
    base: torch.Tensor,  # (N, S) Y (fixed) or F (drift)
    c: float,  # β²
) -> torch.Tensor:
    """f32 product (bf16 operands widened first), returned in ``F.dtype``."""
    if F.dtype == torch.float32:
        prod = A @ F
    else:
        prod = (A.float() @ F.float()).to(F.dtype)
    return c * base + prod
