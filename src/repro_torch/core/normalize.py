"""Matrix normalization (paper §3.1 / §5).

All propagation matrices must be normalized so the iteration is a
contraction-like map (spectral radius ≤ 1); this is the hypothesis of the
convergence proof inherited from MINProp [11] and Heter-LP [14].

* homogeneous similarity:  S = D^{-1/2} P D^{-1/2}
* bipartite association:   S = D_r^{-1/2} R D_c^{-1/2}

Zero-degree rows/columns (isolated entities — e.g. a "new drug" whose
interactions were all deleted in the §6.2.3 experiment) get a zero inverse
degree instead of inf, i.e. they emit/receive nothing through that block.
"""
from __future__ import annotations

import numpy as np


def _inv_sqrt(d: np.ndarray) -> np.ndarray:
    out = np.zeros_like(d, dtype=np.float64)
    nz = d > 0
    out[nz] = 1.0 / np.sqrt(d[nz])
    return out


def symmetric_normalize(P: np.ndarray) -> np.ndarray:
    """D^{-1/2} P D^{-1/2} with zero-degree guard."""
    P = np.asarray(P, dtype=np.float64)
    if P.ndim != 2 or P.shape[0] != P.shape[1]:
        raise ValueError(f"expected square matrix, got {P.shape}")
    d = P.sum(axis=1)
    inv = _inv_sqrt(d)
    return inv[:, None] * P * inv[None, :]


def bipartite_normalize(R: np.ndarray) -> np.ndarray:
    """D_r^{-1/2} R D_c^{-1/2} with zero-degree guard."""
    R = np.asarray(R, dtype=np.float64)
    if R.ndim != 2:
        raise ValueError(f"expected matrix, got {R.shape}")
    dr = R.sum(axis=1)
    dc = R.sum(axis=0)
    return _inv_sqrt(dr)[:, None] * R * _inv_sqrt(dc)[None, :]


def spectral_radius_upper_bound(S: np.ndarray) -> float:
    """Cheap upper bound via the max row sum (∞-norm)."""
    return float(np.abs(S).sum(axis=1).max(initial=0.0))
