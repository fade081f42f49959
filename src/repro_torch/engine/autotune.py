"""Blocked-CSR layout parameters.

The reference (``repro.engine.autotune``) sweeps these once per host and
operator shape class and persists the winners.  This package has no
GPU-keyed cache or sweep yet, so every engine resolves to
:data:`DEFAULT_PARAMS` — exactly what the reference does with a cold cache
or ``LPConfig(autotune=False)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TunedParams:
    """One blocked-CSR layout (the reference's Pallas panel sizes have no
    counterpart here: the CUDA kernel sizes its own blocks)."""

    block_rows: int = 64
    width_mult: int = 8


DEFAULT_PARAMS = TunedParams()


def network_nnz(norm) -> int:
    """Cheap nnz estimate off the normalized blocks (no COO assembly)."""
    nnz = sum(int(np.count_nonzero(s)) for s in norm.S_homo)
    nnz += 2 * sum(int(np.count_nonzero(s)) for s in norm.S_het.values())
    return nnz


__all__ = ["DEFAULT_PARAMS", "TunedParams", "network_nnz"]
