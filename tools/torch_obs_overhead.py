#!/usr/bin/env python3
"""Where the ``metrics`` obs level's serve cost goes, at the full serve size.

Drives the batched burst of the ``serve/obs_overhead`` bench record
(``repro_torch.bench.suites.serve``: the 223-drug drugnet on the ``dense``
engine, 80-query bursts through a fresh serve engine, ``max_batch`` 64) at
three telemetry levels: ``off``, ``metrics``, and ``metrics`` with a live
stream flushed every 50 ms (``streaming``).  After two warm-up bursts per
level it interleaves ``--bursts`` bursts per level in one process, the
order of the levels rotating each round, and prints each level's median
qps, its spread (min, max, interquartile range) and the median overhead
``1 - qps_level / qps_off``, beside the best-of figure the bench record
takes.  Then it times one burst per level under ``cProfile`` (host time
per function, the recording path's functions named) and traces one burst
per level under ``torch.profiler`` (device busy time, the host's CUDA
runtime calls that wait on the card).

The last line is one JSON object of the medians and spreads.  ``--root``
names the checkout whose ``src/`` is used (default: this one), so that a
parent tree unpacked under the ignored ``build/`` is measured in the same
call, in turns.

Run from the repository root:

    python3 tools/torch_obs_overhead.py [--root DIR] [--bursts 7] [--device cuda]
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

LEVELS = ("off", "metrics", "streaming")
#: host functions of the recording path, summed in the cProfile report
RECORDING = ("telemetry.py", "metrics.py", "_record_tick", "_track_inflight", "_count")
#: CUDA runtime calls that make the host wait for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def full_args(device, queries):
    """The serve suite's full-pass knobs (``bench --full --only serve``)."""
    return argparse.Namespace(
        alg="dhlp2", sigma=1e-4, engine="dense", drugs=223, diseases=150, targets=95,
        queries=queries, top_k=10, max_batch=64, seed=0, device=device,
    )


def make_burst(serve_mod, QuerySpec, args, session):
    """One burst exactly as ``run_obs_overhead`` times it: a fresh serve
    engine, one warm query, 2 x ``queries`` submitted, the drain timed."""
    import numpy as np

    def burst():
        engine = session.serve_engine()
        rng = np.random.default_rng(args.seed)
        ents = rng.permutation(session.network.sizes[0])[: 2 * args.queries]
        engine.query(QuerySpec(entity=int(ents[-1]), target_type=2, top_k=args.top_k))
        futs = [engine.submit(QuerySpec(entity=int(e), target_type=2, top_k=args.top_k))
                for e in ents]
        t0 = time.monotonic()
        engine.batcher.drain()
        results = [f.result(timeout=600) for f in futs]
        return len(results) / (time.monotonic() - t0)

    return burst


def spread(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "iqr": q[2] - q[0], "n": len(xs)}


def profile_host(burst, top):
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    burst()
    prof.disable()
    wall = time.perf_counter() - t0
    st = pstats.Stats(prof)
    rec_s, rec_calls = 0.0, 0
    for (fname, _, func), (_, ncalls, tottime, _, _) in st.stats.items():
        if any(k in fname or k == func for k in RECORDING):
            rec_s += tottime
            rec_calls += ncalls
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(top)
    return wall, rec_s, rec_calls, buf.getvalue()


def trace_device(torch, burst, dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        burst()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    busy_us, kernels, syncs = 0.0, 0, {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us:
            busy_us += dev_us
            kernels += ev.count
        if any(ev.key.startswith(k) for k in SYNC_CALLS):
            syncs[ev.key] = (ev.count, ev.cpu_time_total)
    return busy_us, kernels, syncs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--bursts", type=int, default=7)
    ap.add_argument("--queries", type=int, default=40, help="a burst sends twice this")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=18, help="cProfile rows printed per level")
    opts = ap.parse_args()
    root = Path(opts.root).resolve()
    sys.path[:0] = [str(root / "src")]
    import torch

    from repro_torch.bench.suites import serve as serve_mod
    from repro_torch.device import resolve_device
    from repro_torch.serve import QuerySpec

    dev = resolve_device(opts.device)
    args = full_args(opts.device, opts.queries)
    net_spec = serve_mod._drugnet(args)
    sessions = {
        "off": serve_mod._session(args, net_spec),
        "metrics": serve_mod._session(args, net_spec, obs_level="metrics"),
        "streaming": serve_mod._session(args, net_spec, obs_level="metrics"),
    }
    stream_dir = tempfile.mkdtemp(prefix="obs_overhead_stream_")
    sessions["streaming"].telemetry.attach_stream(stream_dir, interval_s=0.05)
    bursts = {lv: make_burst(serve_mod, QuerySpec, args, s) for lv, s in sessions.items()}
    ctx = torch.cuda.device(dev) if dev.type == "cuda" else None
    if ctx is not None:
        ctx.__enter__()
    try:
        for _ in range(2):
            for lv in LEVELS:
                bursts[lv]()
        qps = {lv: [] for lv in LEVELS}
        paired = {lv: [] for lv in LEVELS[1:]}
        for i in range(opts.bursts):
            order = LEVELS[i % 3:] + LEVELS[:i % 3]
            got = {lv: bursts[lv]() for lv in order}
            for lv in LEVELS:
                qps[lv].append(got[lv])
            for lv in LEVELS[1:]:
                paired[lv].append(1.0 - got[lv] / got["off"])
        print(f"root {root}, device {dev}"
              + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
              + f", {2 * args.queries} queries a burst, {opts.bursts} interleaved bursts a level",
              flush=True)
        summary = {"root": str(root), "queries": 2 * args.queries, "bursts": opts.bursts}
        med_off = statistics.median(qps["off"])
        for lv in LEVELS:
            sp = spread(qps[lv])
            line = (f"  {lv:9s} qps median {sp['median']:.1f} (min {sp['min']:.1f}, max "
                    f"{sp['max']:.1f}, IQR {sp['iqr']:.1f}); best {sp['max']:.1f}")
            if lv != "off":
                over = 1.0 - sp["median"] / med_off
                best = 1.0 - sp["max"] / max(qps["off"])
                pr = spread(paired[lv])
                line += (f"; overhead of medians {over:.4f}, best-of {best:.4f}, per round "
                         f"median {pr['median']:.4f} (min {pr['min']:.4f}, max {pr['max']:.4f})")
                sp.update(overhead_median=over, overhead_best=best, overhead_paired=pr)
            summary[lv] = sp
            print(line, flush=True)
        for lv in LEVELS:
            wall, rec_s, rec_calls, table = profile_host(bursts[lv], opts.top)
            print(f"== cProfile, one {lv} burst: {wall * 1e3:.2f} ms under the profiler; "
                  f"recording path {rec_s * 1e3:.3f} ms in {rec_calls} calls", flush=True)
            print(table, flush=True)
            summary[lv]["cprofile_recording_ms"] = rec_s * 1e3
            summary[lv]["cprofile_recording_calls"] = rec_calls
        for lv in LEVELS:
            busy_us, kernels, syncs = trace_device(torch, bursts[lv], dev)
            print(f"== torch.profiler, one {lv} burst: device busy {busy_us / 1e3:.3f} ms in "
                  f"{kernels} device ops; host waits: "
                  + (", ".join(f"{k} x{c} ({t / 1e3:.3f} ms)" for k, (c, t) in sorted(syncs.items()))
                     or "none"), flush=True)
            summary[lv]["device_busy_ms"] = busy_us / 1e3
            summary[lv]["sync_calls"] = {k: c for k, (c, _) in syncs.items()}
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
        shutil.rmtree(stream_dir, ignore_errors=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
