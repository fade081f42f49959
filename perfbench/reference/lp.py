"""The plain reference: DHLP label propagation in float64 PyTorch.

Written from the paper's equations and the configurations' own statement
of them, with dense or plain sparse products and no kernel.  It imports
torch and numpy only, and it takes nothing the program made: it
normalizes the raw network blocks that the benchmark hands to both sides
and builds its own operator.

Notation (paper §3–§5; ``alpha`` α, ``beta`` β = 1 − α, σ the per-column
stopping threshold):

* ``M`` is block diagonal, each block D^-1/2 P D^-1/2 of a type's
  similarity P; ``H`` holds the association blocks D_r^-1/2 R D_c^-1/2 and
  their transposes; ``h`` scales H (1/(T − 1) for T types).
* DHLP-2 with a drifting seed: F ← β²F + A F, A = αβh·H + α·M, from F = Y.
  With a fixed seed (serving): F ← β²Y + A F; its fixed point is
  β²(I − A)⁻¹ Y.
* DHLP-1 with a fixed seed: an outer step Y' = βY + αh·H F, then an inner
  solve F ← βY' + α·M F to σ; a column stops when max_r |F_new − F| < σ,
  in the inner and in the outer loop alike.
* A column that stops in round k has that round applied: its value is
  the k-th iterate, and the residual that stopped it is that round's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

F64 = torch.float64


def _inv_sqrt(d: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(d)
    nz = d > 0
    out[nz] = 1.0 / torch.sqrt(d[nz])
    return out


def operator_blocks(P: List[np.ndarray], R: Dict[Tuple[int, int], np.ndarray], device):
    """Dense ``(H, M)`` of the normalized network, float64 on ``device``."""
    sizes = [p.shape[0] for p in P]
    offs = np.cumsum([0] + sizes)
    n = int(offs[-1])
    H = torch.zeros((n, n), dtype=F64, device=device)
    M = torch.zeros((n, n), dtype=F64, device=device)
    for t, p in enumerate(P):
        p = torch.as_tensor(p, dtype=F64, device=device)
        p = (p + p.T) / 2.0
        inv = _inv_sqrt(p.sum(1))
        M[offs[t] : offs[t + 1], offs[t] : offs[t + 1]] = inv[:, None] * p * inv[None, :]
    for (i, j), r in R.items():
        r = torch.as_tensor(r, dtype=F64, device=device)
        s = _inv_sqrt(r.sum(1))[:, None] * r * _inv_sqrt(r.sum(0))[None, :]
        H[offs[i] : offs[i + 1], offs[j] : offs[j + 1]] = s
        H[offs[j] : offs[j + 1], offs[i] : offs[i + 1]] = s.T
    return H, M


def hetero_scale(num_types: int) -> float:
    return 1.0 / max(1, num_types - 1)


def fused_operator(H, M, alpha: float, h: float) -> torch.Tensor:
    return alpha * (1.0 - alpha) * h * H + alpha * M


def iterates_at(A, Y, F0, counts: torch.Tensor, *, beta2: float, drift: bool):
    """Each column's iterate at its own round count.

    Rounds F ← β²·base + A F from ``F0``, ``base`` = F (drift) or Y.
    Returns ``(F, d_last, d_prev)``: column c after ``counts[c]`` rounds,
    the residual max_r |F_k − F_{k−1}| of its last round, and of the round
    before (``inf`` where there is none).
    """
    counts = counts.to(device=A.device, dtype=torch.long)
    s = Y.shape[1]
    out = torch.empty_like(F0)
    d_last = torch.full((s,), float("inf"), dtype=F64, device=A.device)
    d_prev = torch.full((s,), float("inf"), dtype=F64, device=A.device)
    F = F0.clone()
    for k in range(1, int(counts.max()) + 1 if s else 1):
        Fn = beta2 * (F if drift else Y) + A @ F
        d = (Fn - F).abs().amax(0)
        now = counts == k
        out[:, now] = Fn[:, now]
        d_last[now] = d[now]
        nxt = counts == k + 1
        d_prev[nxt] = d[nxt]
        F = Fn
    zero = counts == 0
    out[:, zero] = F0[:, zero]
    return out, d_last, d_prev


def fixed_point(A, Y, *, beta2: float) -> torch.Tensor:
    eye = torch.eye(A.shape[0], dtype=F64, device=A.device)
    return torch.linalg.solve(eye - A, beta2 * Y)


def dhlp1(H, M, Y, *, alpha: float, h: float, sigma: float, max_iter: int, max_inner: int):
    """DHLP-1, fixed seed, every column stopped by its own residuals."""
    beta = 1.0 - alpha
    s = Y.shape[1]
    F = Y.clone()
    active = torch.ones(s, dtype=torch.bool, device=Y.device)
    it = 0
    while it < max_iter and bool(active.any()):
        Yp = beta * Y + alpha * h * (H @ F)
        Fi, iact = F, active.clone()
        inner = 0
        while inner < max_inner and bool(iact.any()):
            Fn = beta * Yp + alpha * (M @ Fi)
            d = (Fn - Fi).abs().amax(0)
            Fi = torch.where(iact[None, :], Fn, Fi)
            iact &= ~(d < sigma)
            inner += 1
        Fn = torch.where(active[None, :], Fi, F)
        d = (Fn - F).abs().amax(0)
        F = Fn
        active &= ~(d < sigma)
        it += 1
    return F


def csr_operator(src, dst, w, n: int) -> torch.Tensor:
    """W[dst, src] = w as a float64 CSR matrix, duplicate edges summed."""
    dst_l, src_l = dst.long(), src.long()
    return torch.sparse_coo_tensor(
        torch.stack([dst_l, src_l]), w.to(F64), (n, n), check_invariants=False
    ).coalesce().to_sparse_csr()


def bio_rounds(W, Y, *, rounds: int, beta2: float) -> torch.Tensor:
    """``rounds`` rounds F ← β²Y + W F from F = Y."""
    Y = Y.to(F64)
    F = Y
    for _ in range(rounds):
        F = beta2 * Y + W @ F
    return F


def topk(scores: torch.Tensor, exclude: torch.Tensor, k: int):
    """Per row, the ``k`` best entries outside ``exclude``, ties by index:
    ``(indices, values)``, values descending."""
    masked = torch.where(exclude, torch.full_like(scores, float("-inf")), scores)
    order = torch.sort(-masked, dim=1, stable=True).indices[:, :k]
    return order, masked.gather(1, order)
