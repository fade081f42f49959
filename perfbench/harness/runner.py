"""One run of one cell: set-up, the window, the readings, the check."""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Dict, Optional, TextIO

import torch

from perfbench.harness import peaks, trace
from perfbench.harness.cells import KINDS
from perfbench.harness.spec import Cell

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    trace: Optional[trace.Trace]
    counters: dict
    peaks: Optional[dict]


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def run(cell: Cell, *, seed: int, seconds: float, traced: bool, device: str, t0: float,
        control: bool = False, log: TextIO = sys.stderr) -> dict:
    """Run ``cell`` once and return its result line (a dict).

    ``t0`` is the host clock at the process's start: set-up runs from it
    to the window's start, imports and the first build included."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.init()  # the allocator's statistics exist only once CUDA is up
        torch.cuda.reset_peak_memory_stats(dev)
    drv = KINDS[cell.traffic["kind"]](cell.config, cell.traffic, seed, device, control)
    if on_card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    tracer = trace.Tracer(traced)
    with tracer.window():
        status = drv.window(seconds, tracer)
    mem = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": int(mem)}
    print(drv.describe(), file=log)
    metrics: Dict[str, dict] = {}
    breakdown = None
    if traced:
        tr = trace.read(tracer.prof)
        tracer.prof = None
        device_rec["busy_s"] = tr.busy_s
        device_rec["window_s"] = tr.window_s
        ctx = Context(trace=tr, counters=drv.counters(), peaks=peaks.peaks_for(kind))
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = tr.breakdown()
        del tr, ctx
    else:
        e2e = drv.end_to_end()
        e2e["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    numbers = drv.check()
    check = {}
    correct = True
    for name in sorted(set(numbers) | set(cell.limits)):
        v, lim = numbers.get(name, math.inf), cell.limits.get(name)
        ok = lim is not None and v <= lim
        correct &= ok
        check[name] = {"value": _num(v), "limit": lim}
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAILED'}", file=log)
    out = {"correct": bool(correct), "attempted": int(status["attempted"]),
           "failed": int(status["failed"]), "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    # last, after the readers and the check: whatever loaded a module by now
    # leaves the run without a result
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(f"modules loaded that no run may hold: {', '.join(bad)}")
    return out
