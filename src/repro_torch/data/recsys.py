"""Synthetic CTR data with planted feature-interaction structure.

The port's copy of ``repro.data.recsys``: the same numpy draws, so the
same seed and step give the same batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class CTRDataConfig:
    n_sparse: int = 40
    n_dense: int = 13
    vocab_per_field: int = 100_000
    seed: int = 0


def sample_ctr_batch(cfg: CTRDataConfig, batch: int, step: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(cfg.seed + step * 7919)
    # Zipf-ish categorical ids (realistic head-heavy vocab usage)
    raw = rng.zipf(1.3, size=(batch, cfg.n_sparse))
    sparse = np.minimum(raw - 1, cfg.vocab_per_field - 1).astype(np.int32)
    dense = rng.normal(0, 1, (batch, cfg.n_dense)).astype(np.float32)
    # planted CTR: per-field hash weights + a dense interaction
    field_w = np.sin(np.arange(cfg.n_sparse) * 2.17 + 1.0)
    logit = (
        (np.sin(sparse * 0.37) * field_w[None, :]).sum(axis=1) * 0.3
        + dense[:, 0] * 0.5
        - 0.7
    )
    labels = (rng.random(batch) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    return {"sparse": sparse, "dense": dense, "labels": labels}


__all__ = ["CTRDataConfig", "sample_ctr_batch"]
