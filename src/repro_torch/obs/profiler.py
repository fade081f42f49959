"""Profiler hooks: ``torch.profiler`` traces + kernel timing (DESIGN.md §14.4).

Two opt-in capture paths, both active only at ``obs.level="profile"``:

* :func:`profile_phase` — a ``torch.profiler.profile`` context the
  Session wraps around its solve/serve phases (CPU activity, and the
  card's when the phase runs on one), with the phase as a
  ``record_function`` range, writing a Chrome trace under
  ``results/<run_id>/telemetry/profile/<phase>/``;
* the kernel hook — :func:`kernel_clock` / :func:`kernel_time` pairs in
  the ``kernels/`` op wrappers.  Per-variant wall times land in
  ``kernel.<name>.latency_s`` histograms and ``kernel.<name>.calls``
  counters, the variant named by the route taken: ``.kernel`` for a
  launch on a card, ``.ref`` for the plain version on the CPU.

The kernel hook is a module global, not a parameter: op wrappers are
called from deep inside engine loops where threading a telemetry handle
through every signature would reach every engine.  When no collector is
installed, the cost per op call is one global load + one ``is None``
branch.  With one installed, both ends synchronize the card the operands
live on (not the current one: serve launches from the batcher thread),
so earlier queued work is not charged to this launch and the time covers
the launch's device work.  There is no tracing step in the port, so
every call is recorded; a hooked run is slower than an unhooked one.

Beside the kernel hook, for the same reason, sit the hot-path spans:
:func:`hot_span` ranges opened inside the engines' host loops, the
ranking and the ``dhlp-bio`` plan build, where no telemetry handle
reaches (``lp.seeds``, ``lp.upload``, ``lp.round``, ``lp.halt``,
``lp.download``, ``lp.extract``, ``lp.topk``, ``bio.plan`` and its parts
``bio.plan.download`` / ``.bucket`` / ``.upload``).  With no profiler
recording and no collector installed a call is one global load and one
C-level check, and returns the shared no-op span.  While a
``torch.profiler`` records, the span is a ``_RecordFunctionFast`` range:
a plain ``cpu_op`` event on the profiler's clock, in the same trace as
the card's kernels.  ``record_function`` is not used there: it makes a
user annotation, which the profiler mirrors as a device-side
``gpu_user_annotation`` of the same name around the kernels launched
inside it, and a reader of the device timeline would count that as
device work.  With a collector installed (the profile level), the span
is also a ``trace_span`` of kind ``hot`` in its telemetry, parented under
whatever span is open, so ``events.jsonl`` carries the same names.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch._C._profiler import _RecordFunctionFast

from repro_torch.obs.telemetry import _NULL_SPAN

_COLLECTOR = None


def install_kernel_hook(telemetry) -> None:
    """Route kernel timings into ``telemetry`` (one collector at a time)."""
    global _COLLECTOR
    _COLLECTOR = telemetry


def uninstall_kernel_hook() -> None:
    global _COLLECTOR
    _COLLECTOR = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_clock(device: torch.device) -> Optional[float]:
    """Timestamp for a kernel-op call on ``device``; None when no collector
    is active.  Waits for the work already queued on the card first."""
    if _COLLECTOR is None:
        return None
    _sync(device)
    return time.perf_counter()


def kernel_time(name: str, t0: Optional[float], out):
    """Record one kernel-op wall time; returns ``out`` unchanged.

    ``out`` is the op's result (a tensor, or a tuple whose first item is
    one); its card is synchronized before the clock is read."""
    tel = _COLLECTOR
    if tel is None or t0 is None:
        return out
    _sync((out[0] if isinstance(out, tuple) else out).device)
    tel.observe(f"kernel.{name}.latency_s", time.perf_counter() - t0)
    tel.count(f"kernel.{name}.calls")
    return out


#: whether a ``torch.profiler`` records in this process (one C call)
_profiling = torch._C._autograd._profiler_enabled


class _HotSpan:
    """A profiler range (none while no profiler records) and a telemetry
    span (the no-op one below the trace level), opened and closed together."""

    __slots__ = ("_range", "_span")

    def __init__(self, name: str, tel):
        self._range = _RecordFunctionFast(name) if _profiling() else None
        self._span = tel.trace_span("hot", name)

    def __enter__(self) -> "_HotSpan":
        self._span.__enter__()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        self._span.__exit__(*exc)


def hot_span(name: str):
    """A span around host work deep in the hot path (module docstring).

    Use as ``with hot_span("lp.round"): ...``; the names are listed in the
    module docstring and read by the benchmark's per-layer metrics."""
    tel = _COLLECTOR
    if tel is None:
        return _RecordFunctionFast(name) if _profiling() else _NULL_SPAN
    return _HotSpan(name, tel)


@contextlib.contextmanager
def profile_phase(telemetry, out_dir: str, phase: str, device: Optional[torch.device] = None):
    """``torch.profiler`` around one Session phase (profile level only).

    Records CPU activity, and the card's when ``device`` is a CUDA
    device, and writes ``trace.json`` (Chrome trace format) under
    ``<out_dir>/profile/<phase>/``.  The profiler runs one warm-up step
    (opened and closed at once, after a synchronize) before the recorded
    one: device events of the first moments after the profiler starts can
    be lost otherwise.
    """
    if telemetry is None or not telemetry.profile_enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    trace_dir = os.path.join(out_dir, "profile", phase)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    on_card = device is not None and device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    telemetry.event("profile.trace", phase=phase, dir=trace_dir)
    with profile(
        activities=activities,
        schedule=schedule(wait=0, warmup=1, active=1),
        on_trace_ready=lambda prof: prof.export_chrome_trace(path),
    ) as prof:
        if on_card:
            _sync(device)
        prof.step()
        with record_function(f"phase:{phase}"):
            yield trace_dir
        if on_card:
            _sync(device)
