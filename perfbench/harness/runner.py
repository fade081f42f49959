"""One run of one cell: set-up, the window, the readings, the check."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Dict, List, Optional, TextIO, Tuple

import torch

from perfbench.harness import peaks, trace, world
from perfbench.harness.cells import KINDS
from perfbench.harness.spec import Cell

#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class ForbiddenModules(RuntimeError):
    pass


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads.  ``ranks``: each rank's
    ``rank``, ``memory_peak_bytes``, ``busy_s`` and ``window_s``, from its
    own trace (``trace`` is rank 0's)."""

    trace: Optional[trace.Trace]
    counters: dict
    peaks: Optional[dict]
    ranks: Optional[List[dict]] = None


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def loop_of(cell: Cell) -> Tuple[type, Tuple[str, ...]]:
    """The cell's traffic kind: the harness's own (``cells.KINDS``) or
    ``perfbench/kinds/<kind>.py``'s ``Loop``, with the ranges it opens."""
    kind = cell.traffic["kind"]
    if kind in KINDS:
        return KINDS[kind], ()
    mod = cell.kind_file()
    return mod.Loop, tuple(getattr(mod, "RANGES", ()))


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def run(cell: Cell, *, seed: int, seconds: float, traced: bool, device: str, t0: float,
        control: bool = False, log: TextIO = sys.stderr,
        member: Optional[world.Member] = None) -> Optional[dict]:
    """Run ``cell`` once and return its result line (a dict).

    ``t0`` is the host clock at the process's start: set-up runs from it
    to the window's start, imports and the first build included.

    ``member``: this process's rank of a cell on several chips.  Every rank
    sets up, runs the window to rank 0's one decision and reads its own
    peak and trace.  The others then free their state and send rank 0
    those readings and the modules they hold (:func:`forbidden_modules`),
    which is the last they do, and return ``None``; rank 0 runs the
    readers and the check and returns the result, or raises
    :class:`ForbiddenModules` where any rank holds such a module."""
    loop, ranges = loop_of(cell)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.init()  # the allocator's statistics exist only once CUDA is up
        torch.cuda.reset_peak_memory_stats(dev)
    drv = loop(cell.config, cell.traffic, seed, device, control)
    if on_card:
        torch.cuda.synchronize(dev)
    if member is not None:
        member.barrier()  # the window starts once every rank is set up
    setup_s = time.perf_counter() - t0
    tracer = trace.Tracer(traced, ranges)
    with tracer.window(ready=None if member is None else member.barrier):
        status = drv.window(seconds, tracer,
                            done=world.Until(seconds, None if member is None else member.group))
    mem = torch.cuda.max_memory_allocated(dev) if on_card else 0
    tr = None
    mine = {"rank": 0 if member is None else member.rank, "memory_peak_bytes": int(mem)}
    if traced:
        tr = trace.read(tracer.prof, tracer.ranges)
        tracer.prof = None
        mine.update(busy_s=tr.busy_s, window_s=tr.window_s)
    if member is not None and member.rank:
        del drv, tr
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        mine["forbidden"] = forbidden_modules()  # all this rank runs is behind it
        member.gather(mine)
        return None
    ranks = [mine] if member is None else member.gather(mine)
    held = {r["rank"]: r.pop("forbidden", []) for r in ranks}
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": max(r["memory_peak_bytes"] for r in ranks)}
    if member is not None:
        device_rec["ranks"] = ranks
    print(drv.describe(), file=log)
    metrics: Dict[str, dict] = {}
    breakdown = None
    if traced:
        device_rec["busy_s"] = sum(r["busy_s"] for r in ranks) / len(ranks)
        device_rec["window_s"] = tr.window_s
        ctx = Context(trace=tr, counters=drv.counters(), peaks=peaks.peaks_for(kind), ranks=ranks)
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
    # last, after the readers and the check: whatever loaded a module by now,
    # on any rank, leaves the run without a result
    held[0] = forbidden_modules()
    bad = [", ".join(mods) + ("" if member is None else f" (rank {r})")
           for r, mods in sorted(held.items()) if mods]
    if bad:
        raise ForbiddenModules(f"modules loaded that no run may hold: {'; '.join(bad)}")
    return out
