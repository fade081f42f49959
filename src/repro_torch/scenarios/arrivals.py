"""Arrival processes for serve query traces (DESIGN.md §12.3).

Three processes span the latency-tail axes a serving stack cares about:

* ``poisson`` — memoryless baseline: exponential inter-arrival gaps at a
  constant rate (what most QPS numbers implicitly assume);
* ``bursty`` — a two-state Markov-modulated Poisson process: quiet
  periods punctuated by bursts at ``burst_factor``× the quiet rate.
  Mean rate is held at ``rate_qps``, so bursty vs poisson isolates the
  effect of arrival *correlation* on p95/p99 (queueing, batch pileup);
* ``diurnal`` — an inhomogeneous Poisson process with sinusoidal rate
  (period = the horizon by default): the daily load curve compressed
  into the trace, peak rate ``(1 + diurnal_depth) * rate_qps``.

All generators return sorted arrival offsets in seconds from trace
start; entity selection (Zipf popularity over a node block) lives in
:func:`build_trace` so the same arrival stamps can replay against any
scenario.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.scenarios.base import QueryTrace, ScenarioBundle

ARRIVAL_PROCESSES: Tuple[str, ...] = ("poisson", "bursty", "diurnal")


def poisson_arrivals(
    rate_qps: float, horizon_s: float, rng: np.random.Generator
) -> np.ndarray:
    """Homogeneous Poisson: exponential gaps at ``rate_qps``."""
    if rate_qps <= 0 or horizon_s <= 0:
        raise ValueError("rate_qps and horizon_s must be > 0")
    # draw with slack, then trim to the horizon
    n = max(8, int(rate_qps * horizon_s * 1.5) + 8)
    t = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    while t[-1] < horizon_s:  # pragma: no cover - slack almost always enough
        t = np.concatenate(
            [t, t[-1] + np.cumsum(rng.exponential(1.0 / rate_qps, size=n))]
        )
    return t[t < horizon_s]


def bursty_arrivals(
    rate_qps: float,
    horizon_s: float,
    rng: np.random.Generator,
    *,
    burst_factor: float = 8.0,
    burst_fraction: float = 0.15,
    mean_burst_s: Optional[float] = None,
) -> np.ndarray:
    """Two-state MMPP holding the mean rate at ``rate_qps``.

    The process spends ``burst_fraction`` of the time in the burst state
    (rate = ``burst_factor`` × quiet rate); the quiet rate is solved so
    the time-averaged rate equals ``rate_qps``.  Dwell times are
    exponential with burst mean ``mean_burst_s`` (default: horizon/20).
    """
    if not 0 < burst_fraction < 1:
        raise ValueError("burst_fraction must be in (0, 1)")
    if burst_factor <= 1:
        raise ValueError("burst_factor must be > 1")
    mean_burst = mean_burst_s or horizon_s / 20.0
    mean_quiet = mean_burst * (1.0 - burst_fraction) / burst_fraction
    quiet_rate = rate_qps / (
        burst_fraction * burst_factor + (1.0 - burst_fraction)
    )
    burst_rate = burst_factor * quiet_rate
    times = []
    t = 0.0
    bursting = rng.random() < burst_fraction  # stationary start
    while t < horizon_s:
        dwell = rng.exponential(mean_burst if bursting else mean_quiet)
        end = min(t + dwell, horizon_s)
        rate = burst_rate if bursting else quiet_rate
        span = end - t
        n = rng.poisson(rate * span)
        if n:
            times.append(t + np.sort(rng.random(n)) * span)
        t = end
        bursting = not bursting
    if not times:
        return np.empty(0, dtype=np.float64)
    return np.concatenate(times)


def diurnal_arrivals(
    rate_qps: float,
    horizon_s: float,
    rng: np.random.Generator,
    *,
    depth: float = 0.8,
    period_s: Optional[float] = None,
) -> np.ndarray:
    """Inhomogeneous Poisson via thinning: λ(t) = rate·(1 + depth·sin)."""
    if not 0 <= depth <= 1:
        raise ValueError("depth must be in [0, 1]")
    period = period_s or horizon_s
    lam_max = rate_qps * (1.0 + depth)
    cand = poisson_arrivals(lam_max, horizon_s, rng)
    lam = rate_qps * (1.0 + depth * np.sin(2.0 * np.pi * cand / period))
    keep = rng.random(cand.shape[0]) < lam / lam_max
    return cand[keep]


def arrival_times(
    process: str,
    rate_qps: float,
    horizon_s: float,
    rng: np.random.Generator,
    **kw,
) -> np.ndarray:
    if process == "poisson":
        return poisson_arrivals(rate_qps, horizon_s, rng, **kw)
    if process == "bursty":
        return bursty_arrivals(rate_qps, horizon_s, rng, **kw)
    if process == "diurnal":
        return diurnal_arrivals(rate_qps, horizon_s, rng, **kw)
    raise ValueError(
        f"unknown arrival process {process!r}; known: {ARRIVAL_PROCESSES}"
    )


def zipf_entities(
    n: int,
    count: int,
    rng: np.random.Generator,
    *,
    skew: float = 1.1,
) -> np.ndarray:
    """``count`` draws from a Zipf(skew) popularity law over ``n`` items.

    Item identity is shuffled so popularity is not correlated with node
    id (block layouts put similar nodes at nearby ids).
    """
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-skew)
    w /= w.sum()
    perm = rng.permutation(n)
    return perm[rng.choice(n, size=count, p=w)].astype(np.int32)


def build_trace(
    bundle: ScenarioBundle,
    process: str = "poisson",
    *,
    rate_qps: float = 50.0,
    horizon_s: float = 4.0,
    seed: int = 0,
    zipf_skew: float = 1.1,
    source_type: Optional[int] = None,
    target_type: Optional[int] = None,
    **kw,
) -> QueryTrace:
    """Generate a serve query trace for ``bundle``.

    Queries rank ``target_type`` candidates for entities of
    ``source_type`` (defaults: the bundle's ``eval_pair``), with Zipf
    popularity over the source block and arrival stamps from
    ``process``.
    """
    net = bundle.network
    st = bundle.eval_pair[0] if source_type is None else source_type
    tt = bundle.eval_pair[1] if target_type is None else target_type
    if not 0 <= st < net.num_types or not 0 <= tt < net.num_types:
        raise ValueError(f"source/target type out of range: {(st, tt)}")
    rng = np.random.default_rng(seed)
    t = arrival_times(process, rate_qps, horizon_s, rng, **kw)
    local = zipf_entities(net.sizes[st], len(t), rng, skew=zipf_skew)
    entity = (local + net.offsets[st]).astype(np.int32)
    return QueryTrace(
        t=np.asarray(t, dtype=np.float64),
        entity=entity,
        target_type=np.full(len(t), tt, dtype=np.int32),
        process=process,
        rate_qps=rate_qps,
        horizon_s=horizon_s,
    )
