"""Plain PyTorch versions of the padded-CSR fused rounds.

``out[v] = c·base[v] + Σ_k wgt[v, k] · F[nbr[v, k]]`` — zero-weight pads
are no-ops.  The CPU tests hold them against ``repro``'s oracles and
Pallas kernels; on the card they are what the CUDA kernels are held to.
"""

from __future__ import annotations

import torch

# ``F[nbr]`` materializes an (M, D, S) panel; past this many elements the
# gather runs in column chunks.  Label columns are independent, so a chunk
# changes only the rounding order of the library's reduction.
GATHER_BUDGET = 1 << 27


def csr_aggregate_ref(
    nbr: torch.Tensor,  # (M, D) int32 neighbor ids
    wgt: torch.Tensor,  # (M, D) float weights (0 = pad)
    F: torch.Tensor,  # (N, S) features/labels
) -> torch.Tensor:
    """``Σ_k wgt[·,k] · F[nbr[·,k]]`` accumulated in f32, returned f32."""
    m, d = nbr.shape
    s = F.shape[1]
    idx = nbr.long()
    w = wgt.float()
    chunk = max(1, min(s, GATHER_BUDGET // max(1, m * d)))
    parts = [
        torch.einsum("nd,nds->ns", w, F[:, c0 : c0 + chunk][idx].float())
        for c0 in range(0, s, chunk)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def csr_round_ref(
    nbr: torch.Tensor,  # (M, D) int32 neighbor ids
    wgt: torch.Tensor,  # (M, D) float weights (0 = pad)
    F: torch.Tensor,  # (N, S) features/labels
    base: torch.Tensor,  # (M, S) seed/base panel for the fused epilogue
    c: float,
) -> torch.Tensor:
    """Fused round ``c·base + Σ_k wgt[·,k] · F[nbr[·,k]]`` in ``F.dtype``.

    Accumulated in f32; unlike :func:`csr_round_residual_ref` the result
    takes the gather panel's dtype (a bf16 ``F`` gives a bf16 round).  As
    in ``repro``'s oracle, the sum is rounded to ``F.dtype`` before
    ``c·base`` is added (a second rounding for bf16; exact for f32).  The
    CUDA kernel, like the Pallas one, rounds once.
    """
    acc = csr_aggregate_ref(nbr, wgt, F).to(F.dtype).float()
    return (c * base.float() + acc).to(F.dtype)


def csr_round_residual_ref(
    nbr: torch.Tensor,  # (M, D) int32 neighbor ids
    wgt: torch.Tensor,  # (M, D) float weights (0 = pad)
    F: torch.Tensor,  # (N, S) features/labels (gather panel)
    base: torch.Tensor,  # (M, S) seed/base panel
    prev: torch.Tensor,  # (M, S) pre-round state for this bucket's rows
    c: float,
) -> tuple:
    """Fused superstep: the round plus its convergence residual.

    Returns ``(out, delta)`` with ``out`` in ``base.dtype`` and ``delta``
    shaped ``(1, S)`` — the max over this bucket's rows of ``|out − prev|``
    computed in f32 (the kernel gives one such row per row block).
    """
    out = c * base.float() + csr_aggregate_ref(nbr, wgt, F)
    delta = (out - prev.float()).abs().amax(dim=0, keepdim=True)
    return out.to(base.dtype), delta
