"""Serving load generator: QPS + latency percentiles for the online engine.

Plays four traffic phases against ``repro_torch.serve`` and reports
p50/p95/p99 per phase:

  cold         unique entities, empty cache — every query pays a full solve
  cache        the same entities again — pure LRU hits
  warm         new entities with a populated cache — neighbor warm starts
  incremental  a GraphDelta lands, touched entities re-queried — stale
               warm restarts (delta propagation)

Per-query latency is measured on the synchronous path (batch of one) so
phases are comparable; a final burst measures coalesced throughput
through the micro-batcher.

The trace cell (DESIGN.md §12.3) replays the ``bio_tri`` scenario on a
diurnal arrival process at full offered load, once through the
synchronous-scheduler baseline and once through the pipelined tier, and
carries the strict early-exit agreement gate.  The ``obs_overhead`` cell
A/Bs the batched burst with telemetry off, at ``metrics``, and at
``metrics`` with live streaming.

Every engine runs on the pass's device.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from repro_torch.api import NetworkSpec, ObsSpec, RunSpec, ServeSpec, Session, SolveSpec
from repro_torch.bench.registry import register_suite
from repro_torch.bench.report import telemetry_digest
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples
from repro_torch.core import GraphDelta
from repro_torch.serve import QuerySpec
from repro_torch.serve.replay import replay_trace
from repro_torch.serve.types import percentiles


def _phase(engine, entities, top_k) -> Dict:
    lats: List[float] = []
    rounds: List[int] = []
    sources: List[str] = []
    t_phase = time.monotonic()
    for ent in entities:
        t0 = time.monotonic()
        res = engine.query(QuerySpec(entity=int(ent), target_type=2,
                                     top_k=top_k))
        lats.append(time.monotonic() - t0)
        rounds.append(res.rounds)
        sources.append(res.source)
    wall = time.monotonic() - t_phase
    out = {
        "queries": len(lats),
        "qps": len(lats) / wall,
        "mean_rounds": float(np.mean(rounds)),
        "sources": {s: sources.count(s) for s in set(sources)},
        "latencies": lats,
    }
    out.update(percentiles(lats))
    return out


def _serve_spec(args, **overrides) -> ServeSpec:
    """The pipelined-tier ServeSpec from the suite's knobs (overridable)."""
    early = {"auto": None, "on": True, "off": False}[
        getattr(args, "early_exit", "auto")
    ]
    kw = dict(
        max_batch=args.max_batch,
        max_wait_ms=2.0,
        pipeline_depth=getattr(args, "pipeline_depth", 2),
        cache_shards=getattr(args, "cache_shards", 4),
        early_exit=early,
    )
    kw.update(overrides)
    return ServeSpec(**kw)


#: The pre-pipeline synchronous scheduler, as a knob setting: one batch
#: in flight, one global cache lock, full-superstep solves.
SYNC_BASELINE = dict(pipeline_depth=1, cache_shards=1, early_exit=False)


def _session(args, network: NetworkSpec, obs_level: str = "off") -> Session:
    """One resolved spec per bench invocation: the serve engines below
    share the session's prepared LP engine (DESIGN.md §13)."""
    return Session(
        RunSpec(
            network=network,
            solve=SolveSpec(
                alg=args.alg,
                sigma=args.sigma,
                seed_mode="fixed",
                backend=args.engine,
            ),
            serve=_serve_spec(args),
            obs=ObsSpec(level=obs_level) if obs_level != "off" else None,
        ),
        device=args.device,
    )


def _drugnet(args) -> NetworkSpec:
    return NetworkSpec(
        kind="drugnet",
        seed=args.seed,
        params={
            "n_drug": args.drugs,
            "n_disease": args.diseases,
            "n_target": args.targets,
        },
    )


def run(args) -> Dict[str, Dict]:
    session = _session(args, _drugnet(args))
    net = session.network
    engine = session.serve_engine()
    rng = np.random.default_rng(args.seed)
    n_drug = net.sizes[0]
    q = args.queries
    pool = rng.permutation(n_drug)
    cold_ents = pool[:q]
    warm_ents = pool[q : 2 * q]

    # a throwaway query pays the first-call setup so phase 1 measures solving
    engine.query(QuerySpec(entity=int(pool[-1]), target_type=2, top_k=5))

    report: Dict[str, Dict] = {}
    report["cold"] = _phase(engine, cold_ents, args.top_k)
    report["cache"] = _phase(engine, cold_ents, args.top_k)
    report["warm"] = _phase(engine, warm_ents, args.top_k)

    d = int(rng.integers(n_drug))
    t = int(rng.integers(net.sizes[2]))
    engine.apply_delta(GraphDelta(assoc=[((0, 2), d, t, 1.0)]))
    report["incremental"] = _phase(engine, cold_ents, args.top_k)

    # coalesced throughput: one burst through the micro-batcher
    engine.start()
    t0 = time.monotonic()
    futs = [
        engine.submit(QuerySpec(entity=int(e), target_type=2,
                                top_k=args.top_k))
        for e in np.concatenate([cold_ents, warm_ents])
    ]
    results = [f.result(timeout=600) for f in futs]
    wall = time.monotonic() - t0
    engine.stop()
    burst = {
        "queries": len(results),
        "qps": len(results) / wall,
        "batches": engine.batcher.stats.batches,
        "mean_batch_size": engine.batcher.stats.mean_batch_size,
    }
    burst["latencies"] = [r.latency_s for r in results]
    burst.update(percentiles(burst["latencies"]))
    report["batched_burst"] = burst
    return report


def early_exit_agreement(session, *, entities, target_type, top_k) -> Dict:
    """Strict gate: early-exit batch solves match full-superstep solves.

    One coalesced batch of cold queries through each path (identical
    inputs — empty caches, same spec order), compared on the solved
    label columns.  Fixed-seed mode makes the two mathematically
    identical up to iteration tolerance; the gate uses the same
    tolerance the engine-matrix ``agree_dense`` gate does (5e-3).
    """
    tol = 5e-3
    specs = [
        QuerySpec(entity=int(e), target_type=target_type, top_k=top_k)
        for e in entities
    ]
    if session.spec.resolved_solve().alg != "dhlp2":
        return {"agreement": None, "skipped": "early exit is dhlp2-only"}
    eng_full = session.serve_engine(_bench_sv(early_exit=False))
    eng_ee = session.serve_engine(_bench_sv(early_exit=True))
    res_full = eng_full._solve_batch(specs)
    res_ee = eng_ee._solve_batch(specs)
    diff = 0.0
    for e in entities:
        cf = eng_full.columns.get(0, int(e))
        ce = eng_ee.columns.get(0, int(e))
        diff = max(diff, float(np.max(np.abs(cf - ce))))
    mean_full = float(np.mean([r.rounds for r in res_full]))
    mean_ee = float(np.mean([r.rounds for r in res_ee]))
    return {
        "max_abs_diff": diff,
        "tolerance": tol,
        "agreement": 1.0 if diff <= tol else 0.0,
        "mean_rounds_full": mean_full,
        "mean_rounds_early_exit": mean_ee,
    }


def _bench_sv(**overrides) -> ServeSpec:
    """A minimal one-batch-at-a-time ServeSpec for A/B solve checks."""
    kw = dict(pipeline_depth=1, cache_shards=1, max_batch=64)
    kw.update(overrides)
    return ServeSpec(**kw)


def run_trace(args) -> Dict[str, Dict]:
    """Replay mode: one report section per requested arrival process.

    The replay loop is :func:`repro_torch.serve.replay.replay_trace` —
    the same player ``Session.serve()`` runs for RunSpec ``serve``
    sections.  Unless ``sync_compare`` is off, every process replays
    twice — synchronous baseline first, then the pipelined tier — and the
    report carries ``speedup_vs_sync``.
    """
    import inspect

    import repro_torch.scenarios as sc

    # scenarios that schedule their own timed workload (streaming) must
    # schedule it against THIS replay's horizon/rate, or tail deltas
    # would land past the last query and silently never apply; builders
    # without those knobs are generated as-is
    fn = sc.get_scenario(args.trace).fn
    accepted = inspect.signature(fn).parameters
    extra = {
        k: v
        for k, v in (
            ("horizon_s", args.horizon),
            ("rate_qps", args.rate_qps),
        )
        if k in accepted
    }
    session = _session(
        args,
        NetworkSpec(
            kind="scenario",
            name=args.trace,
            scale=args.scale,
            seed=args.seed,
            params=extra,
            cache=False if args.no_cache else None,
        ),
    )
    bundle = session.bundle
    processes = [p.strip() for p in args.processes.split(",") if p.strip()]
    report: Dict[str, Dict] = {}
    for process in processes:
        trace = sc.build_trace(
            bundle,
            process,
            rate_qps=args.rate_qps,
            horizon_s=args.horizon,
            seed=args.seed,
        )
        if len(trace) == 0:
            raise ValueError(
                f"the {process} trace came out empty "
                f"(rate_qps={args.rate_qps}, horizon={args.horizon})"
            )
        deltas = bundle.deltas if args.apply_deltas else ()

        def replay(sv) -> Dict:
            # fresh serve engine per replay (each starts cold and applies
            # the delta stream from version 0) over the session's one
            # prepared LP engine; a throwaway query pays the first-call
            # setup so the first arrival measures solving
            engine = session.serve_engine(sv)
            engine.query(QuerySpec(
                entity=int(trace.entity[0]),
                target_type=int(trace.target_type[0]),
                top_k=args.top_k,
            ))
            engine.columns.clear()
            return replay_trace(
                engine,
                trace,
                deltas,
                top_k=args.top_k,
                time_scale=args.time_scale,
            )

        if args.sync_compare:
            # baseline FIRST so any shared warmup favors neither side
            sync = replay(_serve_spec(args, **SYNC_BASELINE))
            r = replay(_serve_spec(args))
            r["sync"] = {
                k: sync[k]
                for k in ("qps", "achieved_vs_offered", "p50", "p95",
                          "p99", "wall_s", "batches")
            }
            r["speedup_vs_sync"] = r["qps"] / sync["qps"]
        else:
            r = replay(_serve_spec(args))
        report[process] = r

    # the strict agreement gate rides along with every trace run (its own
    # cold engine pair, not the replays above)
    probe = sc.build_trace(
        bundle, processes[0], rate_qps=args.rate_qps,
        horizon_s=args.horizon, seed=args.seed,
    )
    report["early_exit_agreement"] = early_exit_agreement(
        session,
        entities=np.unique(probe.entity)[:32],
        target_type=int(probe.target_type[0]),
        top_k=args.top_k,
    )
    return report


def run_obs_overhead(args) -> Dict:
    """A/B the batched burst with telemetry off vs metrics.

    The acceptance bar for the obs layer (DESIGN.md §14.2): metrics-level
    recording must cost <= 5% replay QPS.  Both bursts run the identical
    query stream through freshly-built engines of the same spec, so the
    only difference is the telemetry sink.  A discarded first pass warms
    every process-wide cache (kernel loads, plan builds), and each level
    takes its best-of-``repeats`` wall time so OS-scheduler noise on
    millisecond bursts doesn't masquerade as recording overhead.  Only
    the drain is timed: building an engine (on a card, its operator
    upload) stays outside.
    """
    repeats = getattr(args, "obs_repeats", 5)

    def burst(session) -> Dict:
        # fresh serve engine per repeat: every pass starts from an empty
        # column cache, so both levels do identical work
        best: Dict = {}
        for _ in range(repeats):
            engine = session.serve_engine()
            rng = np.random.default_rng(args.seed)
            ents = rng.permutation(session.network.sizes[0])[: 2 * args.queries]
            engine.query(QuerySpec(entity=int(ents[-1]), target_type=2,
                                   top_k=args.top_k))
            # enqueue everything, then drain synchronously: batching is
            # deterministic (ceil(len/max_batch) ticks at either level),
            # so the wall-time delta isolates the recording cost
            futs = [
                engine.submit(QuerySpec(entity=int(e), target_type=2,
                                        top_k=args.top_k))
                for e in ents
            ]
            t0 = time.monotonic()
            engine.batcher.drain()
            results = [f.result(timeout=600) for f in futs]
            wall = time.monotonic() - t0
            if not best or wall < best["wall_s"]:
                best = {
                    "queries": len(results),
                    "wall_s": wall,
                    "qps": len(results) / wall,
                    "latencies": [r.latency_s for r in results],
                }
        return best

    net_spec = _drugnet(args)
    out: Dict = {}
    burst(_session(args, net_spec))  # discarded: warm everything
    out["off"] = burst(_session(args, net_spec))
    metrics_session = _session(args, net_spec, obs_level="metrics")
    out["metrics"] = burst(metrics_session)
    out["telemetry"] = metrics_session.telemetry
    out["overhead_frac"] = 1.0 - out["metrics"]["qps"] / out["off"]["qps"]

    # third arm: metrics + live streaming + OpenMetrics export at an
    # aggressive 50ms cadence — the incremental flush path must stay
    # inside the same <=5% bar as plain recording
    stream_session = _session(args, net_spec, obs_level="metrics")
    stream_dir = tempfile.mkdtemp(prefix="obs_overhead_stream_")
    try:
        stream_session.telemetry.attach_stream(stream_dir, interval_s=0.05)
        out["streaming"] = burst(stream_session)
        stream_session.telemetry.flush(stream_dir)
    finally:
        shutil.rmtree(stream_dir, ignore_errors=True)
    out["overhead_frac_streaming"] = (
        1.0 - out["streaming"]["qps"] / out["off"]["qps"]
    )
    return out


@register_suite("serve",
                description="online query engine QPS/latency phases")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    args = argparse.Namespace(
        alg="dhlp2", sigma=1e-4, engine="dense",
        drugs=40 if fast else 223,
        diseases=30 if fast else 150,
        targets=20 if fast else 95,
        queries=8 if fast else 40,
        top_k=10, max_batch=16 if fast else 64, seed=0,
        device=device,
    )
    report = run(args)
    out: List[BenchRecord] = []
    cold_p50 = report["cold"]["p50"]
    for phase, r in report.items():
        derived = {"qps": r["qps"]}
        if "mean_rounds" in r:
            derived["mean_rounds"] = r["mean_rounds"]
        if phase == "cache":
            derived["speedup_vs_cold"] = cold_p50 / max(r["p50"], 1e-9)
        out.append(BenchRecord(
            suite="serve", name=phase, backend=args.engine,
            params={"drugs": args.drugs, "diseases": args.diseases,
                    "targets": args.targets, "queries": r["queries"],
                    "top_k": args.top_k},
            stats=stats_from_samples(r["latencies"]).to_dict(),
            derived=derived,
        ))
    # pipelined tier vs synchronous scheduler: the diurnal trace at full
    # offered load (time_scale saturates the queue), achieved-vs-offered
    # and p99 in the record, early-exit agreement as the strict gate.
    # speedup_vs_sync is tracked, not hard-gated: wall-clock ratios on
    # shared runners swing.
    targs = argparse.Namespace(
        alg="dhlp2", sigma=1e-4, engine="sparse",
        trace="bio_tri", scale=0.25 if fast else 1.0,
        processes="diurnal",
        rate_qps=120.0 if fast else 240.0,
        horizon=3.0 if fast else 6.0,
        time_scale=1000.0,
        apply_deltas=True, no_cache=False,
        top_k=10, max_batch=64, seed=0,
        pipeline_depth=2, cache_shards=4, early_exit="auto",
        sync_compare=True,
        device=device,
    )
    trep = run_trace(targs)
    d = trep["diurnal"]
    agree = trep["early_exit_agreement"]
    out.append(BenchRecord(
        suite="serve", name="trace_diurnal_pipelined", backend="sparse",
        params={"scenario": targs.trace, "scale": targs.scale,
                "rate_qps": targs.rate_qps, "horizon_s": targs.horizon,
                "time_scale": targs.time_scale, "queries": d["queries"],
                "pipeline_depth": targs.pipeline_depth,
                "cache_shards": targs.cache_shards, "top_k": targs.top_k},
        stats=stats_from_samples(d["latencies"]).to_dict(),
        derived={
            "achieved_qps": d["qps"],
            "offered_qps": d["offered_qps"],
            "achieved_vs_offered": d["achieved_vs_offered"],
            "p99_ms": d["p99"] * 1e3,
            "sync_p99_ms": d["sync"]["p99"] * 1e3,
            "speedup_vs_sync": d["speedup_vs_sync"],
            "early_exit_agreement": agree["agreement"],
        },
        strict=["early_exit_agreement"],
    ))

    # obs-overhead A/B: telemetry must stay cheap (non-strict — wall-clock
    # noise on small bursts — but tracked across the trajectory)
    ab = run_obs_overhead(args)
    out.append(BenchRecord(
        suite="serve", name="obs_overhead", backend=args.engine,
        params={"drugs": args.drugs, "diseases": args.diseases,
                "targets": args.targets,
                "queries": ab["off"]["queries"], "top_k": args.top_k},
        stats=stats_from_samples(ab["metrics"]["latencies"]).to_dict(),
        derived={
            "qps_off": ab["off"]["qps"],
            "qps_metrics": ab["metrics"]["qps"],
            "qps_streaming": ab["streaming"]["qps"],
            "overhead_frac": ab["overhead_frac"],
            "overhead_frac_streaming": ab["overhead_frac_streaming"],
        },
        telemetry=telemetry_digest(ab["telemetry"]),
    ))
    return out
