"""Non-distributed baselines: MINProp [11] and Heter-LP [14].

The paper compares DHLP-1/DHLP-2 against these single-machine algorithms
(Tables 2, 5, 6).  We implement them as faithful per-seed numpy loops:

* MINProp (Hwang & Kuang, SDM 2010) — *sequential* (Gauss–Seidel) sweeps over
  subnetworks: subnetwork i's injection uses the freshest labels of the other
  subnetworks, then an inner iterative solve runs to convergence on i.
* Heter-LP (Shahreza et al., JBI 2017) — per-subnetwork projection+LP update
  applied cyclically with the drifting-seed update of DHLP-2's pseudocode.

Note the DHLP algorithms update all subnetworks *simultaneously* (Jacobi)
because every Giraph vertex runs the same program in a superstep, while the
originals are sequential (Gauss–Seidel).  Both orderings converge to the same
fixed point for fixed seeds (tests assert this); iteration counts differ.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.network import NormalizedNetwork


@dataclasses.dataclass
class RefResult:
    F: np.ndarray
    outer_iters: int
    inner_iters: int


def _hetero_sum(
    norm: NormalizedNetwork, f_blocks: List[np.ndarray], i: int
) -> np.ndarray:
    """Σ_{j≠i} S_ij f_j for one type block."""
    out = np.zeros_like(f_blocks[i])
    for (a, b), S in norm.S_het.items():
        if a == i:
            out += S @ f_blocks[b]
        elif b == i:
            out += S.T @ f_blocks[a]
    return out


def minprop_single_seed(
    norm: NormalizedNetwork,
    y: np.ndarray,
    alpha: float = 0.5,
    sigma: float = 1e-3,
    max_outer: int = 1000,
    max_inner: int = 200,
) -> RefResult:
    """MINProp for one seed vector y (N,) — Gauss–Seidel over subnetworks."""
    beta = 1.0 - alpha
    sl = norm.block_slices()
    y_blocks = [y[s].copy() for s in sl]
    f_blocks = [np.zeros_like(yb) for yb in y_blocks]
    total_inner = 0
    for outer in range(max_outer):
        f_prev = [fb.copy() for fb in f_blocks]
        for i in range(norm.num_types):
            y_prime = beta * y_blocks[i] + alpha * _hetero_sum(norm, f_blocks, i)
            # inner LP solve on subnetwork i (Zhou et al. local/global):
            f = f_blocks[i]
            for _ in range(max_inner):
                f_new = beta * y_prime + alpha * (norm.S_homo[i] @ f)
                total_inner += 1
                if np.max(np.abs(f_new - f)) < sigma:
                    f = f_new
                    break
                f = f_new
            f_blocks[i] = f
        delta = max(
            np.max(np.abs(f_blocks[i] - f_prev[i]))
            for i in range(norm.num_types)
        )
        if delta < sigma:
            return RefResult(np.concatenate(f_blocks), outer + 1, total_inner)
    return RefResult(np.concatenate(f_blocks), max_outer, total_inner)


def heterlp_single_seed(
    norm: NormalizedNetwork,
    y: np.ndarray,
    alpha: float = 0.5,
    sigma: float = 1e-3,
    max_iter: int = 1000,
    seed_mode: str = "drift",
) -> RefResult:
    """Heter-LP-style single-seed propagation (cyclic per-subnetwork)."""
    beta = 1.0 - alpha
    sl = norm.block_slices()
    y_blocks = [y[s].copy() for s in sl]
    f_blocks = [yb.copy() for yb in y_blocks]
    for it in range(max_iter):
        f_prev = [fb.copy() for fb in f_blocks]
        for i in range(norm.num_types):
            src = y_blocks[i] if seed_mode == "fixed" else f_blocks[i]
            y_prime = beta * src + alpha * _hetero_sum(norm, f_blocks, i)
            f_blocks[i] = beta * y_prime + alpha * (norm.S_homo[i] @ f_prev[i])
        delta = max(
            np.max(np.abs(f_blocks[i] - f_prev[i]))
            for i in range(norm.num_types)
        )
        if delta < sigma:
            return RefResult(np.concatenate(f_blocks), it + 1, 0)
    return RefResult(np.concatenate(f_blocks), max_iter, 0)


def run_all_seeds(
    norm: NormalizedNetwork,
    alg: str = "heterlp",
    alpha: float = 0.5,
    sigma: float = 1e-3,
    seeds: Optional[np.ndarray] = None,
    **kw,
) -> RefResult:
    """Sweep all (or given) seeds one at a time — the non-distributed runtime
    the paper's Tables 5/6 measure."""
    n = norm.num_nodes
    if seeds is None:
        seeds = np.eye(n)
    cols, outer, inner = [], 0, 0
    fn = minprop_single_seed if alg == "minprop" else heterlp_single_seed
    for c in range(seeds.shape[1]):
        r = fn(norm, seeds[:, c], alpha=alpha, sigma=sigma, **kw)
        cols.append(r.F[:, None])
        outer = max(outer, r.outer_iters)
        inner += r.inner_iters
    return RefResult(np.concatenate(cols, axis=1), outer, inner)
