"""Plain PyTorch versions of the padded-CSR aggregate and fused rounds.

``out[v] = c·base[v] + Σ_k wgt[v, k] · F[nbr[v, k]]`` — zero-weight pads
are no-ops.  The CPU tests hold them against ``repro``'s oracles and
Pallas kernels; on the card they are what the CUDA kernels are held to.
"""

from __future__ import annotations

import torch

# ``F[nbr]`` materializes an (M, D, S) panel; past this many elements the
# gather runs in chunks: column chunks while the (M, D) index table itself
# fits, else row chunks of full width.  Rows and label columns are
# independent, so a chunk changes only the rounding order of the library's
# reduction.
GATHER_BUDGET = 1 << 27


def _gather(F: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``F[idx]`` for an (M, D) index table, as ``index_select`` (whose
    gradient is an ``index_add_``: the indexing's accumulating
    ``index_put_`` took minutes on the card at ``ogb_products``)."""
    return F.index_select(0, idx.reshape(-1)).view(*idx.shape, F.shape[1])


def _aggregate_f32(
    nbr: torch.Tensor,  # (M, D) int32 neighbor ids
    wgt: torch.Tensor,  # (M, D) float weights (0 = pad)
    F: torch.Tensor,  # (N, S) features/labels
    acc: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``Σ_k wgt[·,k] · F[nbr[·,k]]`` accumulated and returned in ``acc``,
    f32 (the sum the fused rounds add to ``c·base`` before their one
    rounding) unless asked otherwise."""
    m, d = nbr.shape
    s = F.shape[1]
    idx = nbr.long()
    w = wgt.to(acc)
    if m * d <= GATHER_BUDGET:
        rows, cols = m, max(1, min(s, GATHER_BUDGET // max(1, m * d)))
    else:
        cols = max(1, min(s, GATHER_BUDGET // max(1, d)))
        rows = max(1, GATHER_BUDGET // max(1, d * cols))
    parts = [
        torch.cat(
            [
                torch.einsum(
                    "nd,nds->ns",
                    w[r0 : r0 + rows],
                    _gather(F[:, c0 : c0 + cols], idx[r0 : r0 + rows]).to(acc),
                )
                for c0 in range(0, s, cols)
            ],
            dim=1,
        )
        for r0 in range(0, m, rows)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def csr_aggregate_ref(
    nbr: torch.Tensor,  # (M, D) int32 neighbor ids
    wgt: torch.Tensor,  # (M, D) float weights (0 = pad)
    F: torch.Tensor,  # (N, S) features/labels
) -> torch.Tensor:
    """``Σ_k wgt[·,k] · F[nbr[·,k]]`` accumulated in f32, returned in
    ``F.dtype`` (as ``repro``'s oracle of the same name): the plain
    version of the ``csr_aggregate`` kernel.  An f64 ``F`` (the gradient
    checks of :class:`~repro_torch.kernels.segment_reduce.CSRAggregate`)
    is summed in f64."""
    acc = torch.float64 if F.dtype == torch.float64 else torch.float32
    return _aggregate_f32(nbr, wgt, F, acc).to(F.dtype)


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
    acc = csr_aggregate_ref(nbr, wgt, F).float()
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
    out = c * base.float() + _aggregate_f32(nbr, wgt, F)
    delta = (out - prev.float()).abs().amax(dim=0, keepdim=True)
    return out.to(base.dtype), delta
