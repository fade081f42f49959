"""Exact fixed points of the DHLP iterations (test oracles).

With fixed seeds (``seed_mode="fixed"``) both algorithms converge to the
same linear-system solution:

  DHLP-1 outer fixed point with the inner solve run to convergence:
      F = β(βY + αHF) + αMF
  DHLP-2 fixed-seed fixed point (same algebra):
      F = β(βY + αHF) + αMF

  =>  (I − αβH − αM) F* = β² Y

This is the regularization-framework optimum the paper's §5 proof refers to
(equivalent to MINProp's global optimum for the stacked system).  The matrix
``I − αβH − αM`` is strictly diagonally dominant for α ∈ (0,1) given the
normalization bounds, hence invertible.
"""
from __future__ import annotations

import numpy as np


def fixed_seed_solution(
    H: np.ndarray, M: np.ndarray, Y: np.ndarray, alpha: float
) -> np.ndarray:
    beta = 1.0 - alpha
    n = H.shape[0]
    A = np.eye(n) - alpha * beta * H - alpha * M
    return np.linalg.solve(A, beta * beta * Y)


def dhlp1_inner_solution(
    M_i: np.ndarray, y_prime: np.ndarray, alpha: float
) -> np.ndarray:
    """Closed form of DHLP-1's inner loop: f = (1-α)(I − αS_i)^{-1} y'."""
    beta = 1.0 - alpha
    n = M_i.shape[0]
    return beta * np.linalg.solve(np.eye(n) - alpha * M_i, y_prime)
