"""Plain PyTorch version of the embedding-bag lookup.

``out[b] = Σ_k w[b, k] · table[idx[b, k]]`` — the multi-hot gather and
weighted sum of the recsys model.  The CPU tests hold it against
``repro``'s oracle and Pallas kernel; on the card it is what the CUDA
kernel is held to.
"""

from __future__ import annotations

import torch


def embedding_bag_ref(
    table: torch.Tensor,  # (V, D)
    idx: torch.Tensor,  # (B, K) int32 row ids
    w: torch.Tensor,  # (B, K) per-sample weights (0 = pad)
) -> torch.Tensor:
    """Accumulated in f32, returned in ``table.dtype``."""
    gathered = table[idx.long()].float()  # (B, K, D)
    return torch.einsum("bk,bkd->bd", w.float(), gathered).to(table.dtype)
