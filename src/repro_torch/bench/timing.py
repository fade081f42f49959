"""Timing discipline shared by every benchmark.

One path to a wall-time number: warmup calls (first-call builds
excluded), ``repeats`` measured calls, a device sync on whatever the
callable returns (``torch.cuda.synchronize`` for the cards its CUDA
tensors live on, else the current card once CUDA is in use), and robust
order statistics (median/p10/p90) instead of a single noisy sample.  The
clock is injectable so tests can assert the statistics deterministically.

A kernel's device time comes from :func:`time_cuda_events`: CUDA events
around many launches after a warm-up, L2 flushed before each, the
elapsed time over the count.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence


def _cuda_tensors(value) -> Iterator:
    """The CUDA tensors in ``value`` (a tensor, or lists/tuples/dicts of them)."""
    import torch

    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _cuda_tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _cuda_tensors(v)


def _default_sync(value):
    """Wait for the device work behind ``value``.

    Every card holding one of its CUDA tensors is synchronized; a value
    with none (numpy results, which the engines already copied back)
    still synchronizes the current card once CUDA is in use, so work
    queued by the callable cannot leak out of the measurement.  No error
    is swallowed.
    """
    import torch

    devices = {t.device for t in _cuda_tensors(value)}
    if not devices and torch.cuda.is_available() and torch.cuda.is_initialized():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return value


def _quantile(sorted_xs: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile on an already-sorted sample."""
    if not sorted_xs:
        raise ValueError("empty sample")
    if len(sorted_xs) == 1:
        return float(sorted_xs[0])
    pos = q * (len(sorted_xs) - 1)
    lo = math.floor(pos)
    hi = math.ceil(pos)
    frac = pos - lo
    return float(sorted_xs[lo] * (1.0 - frac) + sorted_xs[hi] * frac)


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Order statistics (seconds) over ``repeats`` measured calls."""

    repeats: int
    warmup: int
    median_s: float
    p10_s: float
    p90_s: float
    mean_s: float
    min_s: float
    max_s: float

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "TimingStats":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})


def stats_from_samples(samples: Iterable[float], *, warmup: int = 0) -> TimingStats:
    """Build :class:`TimingStats` from pre-measured durations (seconds)."""
    xs = sorted(float(s) for s in samples)
    if not xs:
        raise ValueError("stats_from_samples needs at least one sample")
    return TimingStats(
        repeats=len(xs),
        warmup=warmup,
        median_s=_quantile(xs, 0.5),
        p10_s=_quantile(xs, 0.1),
        p90_s=_quantile(xs, 0.9),
        mean_s=sum(xs) / len(xs),
        min_s=xs[0],
        max_s=xs[-1],
    )


def time_callable(
    fn: Callable[[], object],
    *,
    warmup: int = 1,
    repeats: int = 3,
    clock: Optional[Callable[[], float]] = None,
    sync: Optional[Callable[[object], object]] = None,
) -> TimingStats:
    """Time ``fn()`` with warmup, repeats, and device synchronization.

    ``clock`` defaults to ``time.perf_counter`` and is injectable for
    deterministic tests; ``sync`` (default :func:`_default_sync`) is
    applied to the return value inside the timed region so asynchronous
    launches do not leak out of the measurement.
    """
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    clock = clock or time.perf_counter
    sync = sync or _default_sync
    for _ in range(max(0, warmup)):
        sync(fn())
    samples: List[float] = []
    for _ in range(repeats):
        t0 = clock()
        sync(fn())
        samples.append(clock() - t0)
    return stats_from_samples(samples, warmup=max(0, warmup))


#: bytes written between timed launches to evict their inputs from L2
#: (five times the H100's 50 MB)
L2_FLUSH_BYTES = 256 << 20


def time_cuda_events(
    fn: Callable[[], object],
    device,
    *,
    warmup: int = 2,
    iters: int = 10,
    repeats: int = 5,
) -> TimingStats:
    """Device time of one ``fn()`` call on a CUDA ``device``.

    After ``warmup`` calls, each of ``repeats`` samples is the mean over
    ``iters`` calls of their CUDA-event times on the device's current
    stream.  Every call has its own event pair and is preceded, outside
    the pair, by a write of ``L2_FLUSH_BYTES``: each call finds its inputs
    in HBM, as a caller that did other work in between would, and the
    host's launch gaps fall outside the pairs.  Raises on a device that is
    not a card: there is no host-clock fallback for a device time.
    """
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"time_cuda_events needs a CUDA device, got {device}")
    if repeats < 1 or iters < 1:
        raise ValueError("repeats and iters must be >= 1")
    with torch.cuda.device(device):
        scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
        for _ in range(max(0, warmup)):
            fn()
        torch.cuda.synchronize(device)
        samples: List[float] = []
        for _ in range(repeats):
            pairs = []
            for _ in range(iters):
                scratch.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                pairs.append((start, end))
            torch.cuda.synchronize(device)
            total_ms = sum(start.elapsed_time(end) for start, end in pairs)
            samples.append(total_ms / 1e3 / iters)
    return stats_from_samples(samples, warmup=max(0, warmup))


def derived_throughput(
    stats: TimingStats,
    *,
    edges: Optional[int] = None,
    supersteps: Optional[int] = None,
    queries: Optional[int] = None,
    flops: Optional[int] = None,
) -> Dict[str, float]:
    """Derive throughput metrics from the median wall time.

    ``edges`` is per-superstep work: edges/s is edge *traversals* per
    second (edges × supersteps / t) when supersteps is known, matching the
    paper's messages-per-superstep accounting.
    """
    t = max(stats.median_s, 1e-12)
    out: Dict[str, float] = {}
    if edges is not None:
        traversals = edges * (supersteps if supersteps else 1)
        out["edges_per_s"] = traversals / t
    if supersteps is not None:
        out["supersteps_per_s"] = supersteps / t
    if queries is not None:
        out["qps"] = queries / t
    if flops is not None:
        out["gflops"] = flops / t / 1e9
    return out
