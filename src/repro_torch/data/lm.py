"""Synthetic LM token pipeline (the port's copy of ``repro.data.lm``,
numpy only, bit for bit the reference's batches).

Deterministic, seekable token stream (a hash of the global token index) so
that (a) restarts resume mid-epoch without storing cursor state beyond the
step number, and (b) every data-parallel shard draws disjoint slices — the
standard deterministic-data-order contract of large training jobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    # markov-ish structure so the loss has signal to minimize
    structure: int = 97


def sample_batch(cfg: LMDataConfig, step: int,
                 shard: int = 0, num_shards: int = 1) -> Dict[str, np.ndarray]:
    """Batch for (step, shard): disjoint across shards, deterministic."""
    per_shard = cfg.batch // num_shards
    base = (
        np.uint64(step) * np.uint64(cfg.batch * (cfg.seq_len + 1))
        + np.uint64(shard * per_shard * (cfg.seq_len + 1))
        + np.uint64(cfg.seed) * np.uint64(0x1000003)
    )
    idx = base + np.arange(
        per_shard * (cfg.seq_len + 1), dtype=np.uint64
    )
    raw = _splitmix64(idx).reshape(per_shard, cfg.seq_len + 1)
    # structured stream: next token correlates with previous (learnable)
    toks = (raw % np.uint64(cfg.structure)).astype(np.int64)
    toks = np.cumsum(toks, axis=1) % cfg.vocab
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def batch_iterator(cfg: LMDataConfig, start_step: int = 0,
                   shard: int = 0, num_shards: int = 1) -> Iterator[Dict]:
    step = start_step
    while True:
        yield sample_batch(cfg, step, shard, num_shards)
        step += 1
