"""Request/response dataclasses for the serving subsystem."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

#: Admission/drain classes, highest priority first (DESIGN.md §9.1).
#: ``interactive`` is user-facing traffic, ``refresh`` is post-delta
#: re-convergence work, ``bulk`` is offline backfill.
PRIORITY_CLASSES = ("interactive", "refresh", "bulk")
DEFAULT_PRIORITY = "interactive"


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """One ranking query: "rank ``top_k`` ``target_type`` candidates for
    ``entity``" (the paper's step G, per-entity candidate list).

    ``entity`` is a *global* node id; ``target_type`` the type index whose
    block is ranked (e.g. targets for a drug).  ``priority`` selects the
    admission/drain class (``interactive`` > ``refresh`` > ``bulk``).
    """

    entity: int
    target_type: int
    top_k: int = 20
    # serve known-associated entities too (default: exclude them — they
    # would trivially top every repositioning list)
    include_known: bool = False
    priority: str = DEFAULT_PRIORITY


@dataclasses.dataclass
class QueryResult:
    """Ranked candidates plus serving metadata."""

    spec: QuerySpec
    candidates: np.ndarray    # (<= top_k,) local ids within the target block
    scores: np.ndarray        # matching label scores, descending
    target_offset: int        # global id = target_offset + local id
    version: int              # network version the answer was computed on
    source: str               # "cache" | "warm" | "cold"
    rounds: int               # LP rounds this column cost (0 on cache hit)
    latency_s: float = 0.0    # filled by the scheduler/driver

    @property
    def global_candidates(self) -> np.ndarray:
        return self.candidates + self.target_offset


def percentiles(
    latencies: Sequence[float], qs=(50, 95, 99)
) -> Optional[dict]:
    """{p50: ..., p95: ..., p99: ...} in seconds, or None when empty."""
    if not len(latencies):
        return None
    arr = np.asarray(latencies, dtype=np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}
