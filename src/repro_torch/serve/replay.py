"""Workload players for the online engine (DESIGN.md §9.5 / §12.3).

Two ways to drive an :class:`~repro_torch.serve.engine.LPServeEngine` and
report QPS + latency percentiles, shared by ``Session.serve()``, the
legacy serve CLI shim, and ``benchmarks/serve_bench.py``:

* :func:`replay_trace` — replay a scenario :class:`QueryTrace` at its
  own arrival pace (clock optionally compressed), landing the
  scenario's timed GraphDelta stream between the submissions each delta
  precedes, exactly as a live feed would interleave them;
* :func:`play_zipf` — the synthetic zipf-popularity workload the
  original standalone serve CLI played: skewed repeat queries
  over one source type, with optional random association deltas
  interleaved at even intervals.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np

from repro_torch.core.network import GraphDelta
from repro_torch.serve.types import DEFAULT_PRIORITY, QuerySpec, percentiles


def _observe_latencies(engine, telemetry, lats) -> None:
    """Post-hoc latency recording for a telemetry-blind scheduler.

    When the engine's batcher carries its own telemetry, every latency
    was already observed live at completion time (per-window SLO
    evaluation needs that); recording here again would double-count.
    This fallback keeps the standalone pairing — engine built without
    telemetry, player called with one — reporting a full histogram.
    """
    if telemetry is None or getattr(engine.batcher, "_tel", None) is not None:
        return
    for lat in lats:
        telemetry.observe("serve.latency_s", lat)


def _sample(result) -> Dict:
    """Provenance snapshot of one query result (artifact ``sample``)."""
    return {
        "entity": int(result.spec.entity),
        "target_type": int(result.spec.target_type),
        "top_k": int(result.spec.top_k),
        "candidates": [int(c) for c in result.candidates],
        "scores": [float(s) for s in result.scores],
    }


def replay_trace(
    engine,
    trace,
    deltas,
    *,
    top_k: int,
    time_scale: float,
    priority: str = DEFAULT_PRIORITY,
    telemetry=None,
) -> Dict:
    """Submit ``trace`` through the micro-batcher at its own pace.

    ``time_scale > 1`` compresses the clock (a 4s horizon replays in
    4/scale seconds — same arrival *pattern*, proportionally higher
    offered rate).  ``priority`` stamps every replayed query with an
    admission class.  The report includes ``achieved_vs_offered`` — the
    fraction of the offered rate the tier actually sustained (1.0 means
    it kept pace; lower means the trace outran it and queueing delay
    stretched the wall clock).
    """
    deltas = sorted(deltas, key=lambda d: d.t)
    di = 0
    futs = []
    engine.start()
    t0 = time.monotonic()
    for i in range(len(trace)):
        target = float(trace.t[i]) / time_scale
        while di < len(deltas) and deltas[di].t <= float(trace.t[i]):
            wait = deltas[di].t / time_scale - (time.monotonic() - t0)
            if wait > 0:
                time.sleep(wait)
            engine.apply_delta(deltas[di].delta)
            if telemetry is not None:
                telemetry.event("serve.delta", at=float(deltas[di].t))
            di += 1
        wait = target - (time.monotonic() - t0)
        if wait > 0:
            time.sleep(wait)
        futs.append(
            engine.submit(
                QuerySpec(
                    entity=int(trace.entity[i]),
                    target_type=int(trace.target_type[i]),
                    top_k=top_k,
                    priority=priority,
                )
            )
        )
        if telemetry is not None:
            telemetry.maybe_flush()  # submit loop = arrival-side pump
    results = [f.result(timeout=600) for f in futs]
    wall = time.monotonic() - t0
    engine.stop()
    lats = [r.latency_s for r in results]
    _observe_latencies(engine, telemetry, lats)
    sources = [r.source for r in results]
    offered = len(trace) / (trace.horizon_s / time_scale)
    achieved = len(results) / wall
    out = {
        "queries": len(results),
        "offered_qps": offered,
        "qps": achieved,
        "achieved_vs_offered": achieved / offered if offered else 0.0,
        "wall_s": wall,
        "deltas_applied": di,
        "mean_rounds": float(np.mean([r.rounds for r in results])),
        "sources": {s: sources.count(s) for s in set(sources)},
        "batches": engine.batcher.stats.batches,
        "mean_batch_size": engine.batcher.stats.mean_batch_size,
        "latencies": lats,
        "sample": _sample(results[0]),
    }
    out.update(percentiles(lats))
    return out


def play_zipf(
    engine,
    *,
    source_type: int,
    target_type: int,
    requests: int,
    zipf: float,
    deltas: int,
    top_k: int,
    seed: int,
    echo=None,
    telemetry=None,
) -> Dict:
    """Zipf-popular entities of ``source_type`` querying ``target_type``
    candidates, with ``deltas`` random associations landing online at
    even intervals through the workload."""
    net = engine.state.net
    rng = np.random.default_rng(seed)
    n_src = net.sizes[source_type]
    off_src = net.offsets[source_type]
    ranks = rng.permutation(n_src)
    draws = np.minimum(rng.zipf(zipf, size=requests), n_src) - 1
    entities = ranks[draws] + off_src
    delta_at = (
        set(np.linspace(0, requests, deltas + 2, dtype=int)[1:-1])
        if deltas
        else set()
    )
    pair = (
        (source_type, target_type)
        if source_type < target_type
        else (target_type, source_type)
    )

    futures = []
    events: List[Dict] = []
    engine.start()
    t0 = time.monotonic()
    for i, ent in enumerate(entities):
        if i in delta_at:
            # a fresh source→target association lands online
            u = int(rng.integers(net.sizes[source_type]))
            v = int(rng.integers(net.sizes[target_type]))
            a, b = (u, v) if source_type < target_type else (v, u)
            version = engine.apply_delta(GraphDelta(assoc=[(pair, a, b, 1.0)]))
            events.append({"at": int(i), "u": u, "v": v, "version": int(version)})
            if telemetry is not None:
                telemetry.event("serve.delta", at=int(i), version=int(version))
            if echo:
                echo(
                    f"[serve] delta @req {i}: +assoc type{source_type} {u} "
                    f"→ type{target_type} {v} (version {version})"
                )
        futures.append(
            engine.submit(
                QuerySpec(entity=int(ent), target_type=target_type, top_k=top_k)
            )
        )
        if telemetry is not None:
            telemetry.maybe_flush()  # submit loop = arrival-side pump
    results = [f.result(timeout=600) for f in futures]
    wall = time.monotonic() - t0
    engine.stop()

    lats = [r.latency_s for r in results]
    _observe_latencies(engine, telemetry, lats)
    by_source = collections.Counter(r.source for r in results)
    rounds_by = collections.defaultdict(list)
    for r in results:
        rounds_by[r.source].append(r.rounds)
    bstats = engine.batcher.stats
    cstats = engine.columns.stats
    out = {
        "queries": len(results),
        "qps": len(results) / wall,
        "wall_s": wall,
        "sources": dict(by_source),
        "mean_rounds_by_source": {s: float(np.mean(v)) for s, v in rounds_by.items()},
        "deltas": events,
        "batches": bstats.batches,
        "mean_batch_size": bstats.mean_batch_size,
        "rejected": bstats.rejected,
        "cache_hit_rate": cstats.hit_rate,
        "cache_evictions": cstats.evictions,
        "cache_demoted": cstats.invalidations,
        "latencies": lats,
        "sample": _sample(results[0]),
    }
    out.update(percentiles(lats))
    return out
