#!/usr/bin/env python3
"""What the hot-path spans cost, and that they stay off the device timeline.

``repro_torch.obs.profiler.hot_span`` opens the ranges inside the
engines' host loops, the ranking and the ``dhlp-bio`` plan build.  This
script measures, in one process:

1. the off path: ``with hot_span(name): pass`` with no profiler recording
   and no collector installed, in ns per call, beside an empty loop and
   the shared no-op span alone (the off path's own cost is the first
   minus the last);
2. the on path: the same loop while a CPU-only ``torch.profiler``
   records (each call then leaves one event);
3. the trace: a DHLP-2 all-sources solve of the ``powerlaw`` scenario at
   ``--scale`` on ``--engine``, then the ranking of every drug's top 20
   targets, under ``torch.profiler`` with the device's activity when the
   device is a card.  It lists the program ranges found, whether any of
   them is a user annotation, and every device-side event whose name is
   that of a program range (there must be none), and checks that the
   count of ``lp.round`` ranges is the solve's round count and that the
   solve's kernels lie inside its ranges, on the same clock.

With ``--cell``, it runs instead one traced window of that cell of the
benchmark (``perfbench/``: the cell's own set-up and loop, ``--seconds``
long, ``--seed``) and checks the same of the window's trace, and that the
count of ``lp.round`` ranges is the sum of the solves' rounds, or that the
three ``bio.plan.*`` parts add up to within 5 % of ``bio.plan``; it prints
each program range's count and milliseconds a call of the cell.

Exits 1 when a check fails.  The last line is one JSON object.  Run from
the repository root:

    python3 tools/hot_span_check.py [--device cuda] [--scale 1.0] [--calls 1000000]
    python3 tools/hot_span_check.py --cell bio20m-step [--seconds 20] [--seed 1]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PREFIXES = ("lp.", "bio.")


def _ns_per_call(fn, calls: int) -> float:
    t0 = time.perf_counter_ns()
    fn(calls)
    return (time.perf_counter_ns() - t0) / calls


def costs(calls: int) -> dict:
    import torch

    from repro_torch.obs import profiler as prof
    from repro_torch.obs.telemetry import _NULL_SPAN

    def empty(n):
        for _ in range(n):
            pass

    def null(n):
        for _ in range(n):
            with _NULL_SPAN:
                pass

    def hot(n):
        hs = prof.hot_span
        for _ in range(n):
            with hs("lp.topk"):
                pass

    out = {}
    for _ in range(2):  # the second pass is the one kept: warm caches
        out = {"empty_ns": _ns_per_call(empty, calls), "null_span_ns": _ns_per_call(null, calls),
               "hot_span_off_ns": _ns_per_call(hot, calls)}
    on_calls = max(1, calls // 10)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["hot_span_on_ns"] = _ns_per_call(hot, on_calls)
    out["off_path_ns"] = out["hot_span_off_ns"] - out["null_span_ns"]
    return out


def traced_solve(device: str, scale: float, engine: str) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import LPConfig, extract_outputs, topk_exclusive
    from repro_torch.engine import make_engine
    from repro_torch.scenarios import generate

    net = generate("powerlaw", scale=scale, seed=0, cache=False).network
    eng = make_engine(engine, LPConfig(alg="dhlp2", sigma=1e-4, seed_mode="fixed"), device=device)
    eng.run(net)  # warm: builds the kernels and the plan
    on_card = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    known = net.R[(0, 2)] > 0
    with torch.profiler.profile(activities=acts) as p:
        res = eng.run(net)
        block = extract_outputs(res.F, net.normalize()).interactions[(0, 2)]
        top = [topk_exclusive(block[d], 20, known[d]) for d in range(block.shape[0])]
        if on_card:
            torch.cuda.synchronize()
    host, dev_named, annotated = {}, [], []
    kernels = []
    for ev in p.profiler.kineto_results.events():
        name = ev.name()
        program = name.startswith(PREFIXES)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if program:
                dev_named.append(name)
            elif not name.startswith(("Memcpy", "Memset")):
                kernels.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            continue
        if program:
            host.setdefault(name, []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
            if ev.is_user_annotation():
                annotated.append(name)
    # every kernel of the solve runs between the start of its first range
    # (``lp.seeds``) and the end of its last (the ranking's): on one clock,
    # every kernel lies inside that interval
    inside = None
    spans = [iv for ivs in host.values() for iv in ivs]
    if kernels and spans:
        lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
        inside = sum(lo <= s and e <= hi for s, e in kernels) / len(kernels)
    return {
        "device": torch.cuda.get_device_name() if on_card else "cpu",
        "engine": engine,
        "nodes": int(net.num_nodes),
        "outer_iters": int(res.outer_iters),
        "ranges": {k: len(v) for k, v in sorted(host.items())},
        "ms": {k: float(sum(e - s for s, e in v)) / 1e6 for k, v in sorted(host.items())},
        "user_annotations": sorted(set(annotated)),
        "device_events_named_as_ranges": sorted(set(dev_named)),
        "kernels": len(kernels),
        "kernels_inside_ranges_share": inside,
        "topk_lists": len(top),
        "drugs": int(np.asarray(known).shape[0]),
    }


def traced_cell(name: str, seconds: float, seed: int, device: str) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench.harness import cells, host, spans, spec, trace

    cell = spec.load_cell(ROOT, name)
    host.apply(cell.config)
    drv = cells.KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, device)
    tracer = trace.Tracer(True)
    with tracer.window():
        drv.window(seconds, tracer)
    tr = trace.read(tracer.prof)
    idx = spans.ranges(tr)
    per = "step" if cell.traffic["kind"] == "bio_step" else "solve"
    calls = tr.span_count(per)
    out = {"cell": name, "device": torch.cuda.get_device_name() if device.startswith("cuda")
           else "cpu", "calls": calls,
           "ranges": {k: int(v[0].size) for k, v in sorted(idx.items())},
           "ms_per_call": {k: float((v[1] - v[0]).sum()) / 1e6 / calls
                           for k, v in sorted(idx.items())},
           "device_events_named_as_ranges": sorted({n for n in tr.dev_name
                                                    if n.startswith(PREFIXES)}),
           "named_idle_share": spans.named_idle_share(tr),
           "idle_gaps": tr.breakdown()["idle_gaps"]}
    if per == "solve":
        out["rounds"] = int(sum(drv.rounds))
    else:
        plan = idx["bio.plan"][1] - idx["bio.plan"][0]
        parts = sum(idx[p][1] - idx[p][0] for p in
                    ("bio.plan.download", "bio.plan.bucket", "bio.plan.upload"))
        out["plan_parts_share"] = [float(x) for x in parts / plan]
    return out


def smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--engine", default="kernel")
    ap.add_argument("--calls", type=int, default=1_000_000)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    card = smi() if args.device.startswith("cuda") else "cpu"
    failed = []
    if args.cell is not None:
        out = {"card": card, "cell": traced_cell(args.cell, args.seconds, args.seed,
                                                 args.device)}
        c = out["cell"]
        if c["device_events_named_as_ranges"]:
            failed.append("a device-side event carries a program range's name")
        if "rounds" in c and c["ranges"].get("lp.round", 0) != c["rounds"]:
            failed.append("lp.round ranges != the solves' rounds")
        if "plan_parts_share" in c and not all(0.95 <= x <= 1.0 for x in c["plan_parts_share"]):
            failed.append("the plan's three parts are not within 5 % of bio.plan")
        return _report(out, failed)
    out = {"card": card, "costs": costs(args.calls),
           "trace": traced_solve(args.device, args.scale, args.engine)}
    tr = out["trace"]
    if tr["device_events_named_as_ranges"]:
        failed.append("a device-side event carries a program range's name")
    if tr["user_annotations"]:
        failed.append("a program range is a user annotation")
    if tr["ranges"].get("lp.round", 0) != tr["outer_iters"]:
        failed.append("lp.round ranges != the solve's rounds")
    if tr["ranges"].get("lp.topk", 0) != tr["drugs"]:
        failed.append("lp.topk ranges != the ranked drugs")
    if tr["kernels_inside_ranges_share"] not in (None, 1.0):
        failed.append("kernels outside the program's ranges: two clocks")
    return _report(out, failed)


def _report(out: dict, failed: list) -> int:
    for line in failed:
        print(f"FAILED: {line}", file=sys.stderr)
    out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
