"""Structured telemetry: spans, events, and the metrics facade (DESIGN.md §14).

One :class:`Telemetry` object rides through a
:class:`~repro_torch.api.session.Session` and is threaded (as an optional
keyword) into the serve stack and the observed-solve loop.  Design
constraints, in priority order:

* **off is free** — every recording entry point starts with one branch;
  when ``level == "off"`` the only state change is a host-side
  ``suppressed`` counter increment (no allocation, no lock, no clock
  read, and never a callback into jitted code);
* **spans carry explicit parent ids** — the taxonomy is
  ``run > phase > superstep`` for solves and ``run > batch > query`` for
  serving.  Parentage is tracked per-thread (the micro-batcher closes
  batch spans on its own thread) with an *ambient* fallback: a span
  opened on a thread with an empty stack parents to the innermost open
  ``run``/``phase`` span, so background-thread batches nest under the
  serve phase;
* **deterministic ids** — one process-wide increment under a lock; the
  clock is injectable so tests assert exact timings.

Levels: ``off`` < ``metrics`` (counters/gauges/histograms + structural
spans) < ``trace`` (adds per-superstep / per-query spans) < ``profile``
(adds ``torch.profiler`` capture + kernel timing hooks, see
:mod:`repro_torch.obs.profiler`).

**Streaming** (DESIGN.md §14.7): :meth:`Telemetry.attach_stream` turns
the end-of-run recorder into a live sink.  Producers call
:meth:`Telemetry.maybe_flush` from their natural pump points (scheduler
tick, observed superstep, replay loop) — one attribute test when no
stream is attached, one clock compare when one is.  Each elapsed
interval appends the not-yet-written events to an append-only segment
file (``events-NNNN.jsonl``, meta line first, rotated every
``segment_records`` lines) and atomically rotates the point-in-time
snapshots (``metrics.jsonl`` / ``summary.json`` / ``metrics.prom``) via
temp-file + ``os.replace``, so a concurrent reader never sees a torn
snapshot.  Flush listeners (the SLO watchdog) run once per tick, after
the write.  The final :meth:`flush` consolidates: it writes the complete
``events.jsonl`` and removes the segments, leaving the same directory
layout a non-streaming run produces.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

SCHEMA = "repro.obs/v1"
LEVELS = ("off", "metrics", "trace", "profile")

#: span kinds that update the ambient parent for spans opened on other
#: threads (coarse structural spans only — a batch span must not become
#: the ambient parent of an unrelated phase)
_AMBIENT_KINDS = ("run", "phase")


class _NullSpan:
    """Reusable no-op span: the disabled path allocates nothing."""

    __slots__ = ()
    id = None
    parent = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


_NULL_SPAN = _NullSpan()


def _atomic_write(path: str, text: str) -> str:
    """Write ``text`` to ``path`` via temp-file + rename (snapshot
    rotation: a concurrent ``--follow`` reader never sees a torn file)."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


class _StreamSink:
    """Bookkeeping for one attached streaming directory."""

    __slots__ = (
        "dir",
        "interval_s",
        "segment_records",
        "next_deadline",
        "flushed",
        "seg_index",
        "seg_path",
        "seg_count",
        "ticks",
    )

    def __init__(
        self, dir_path: str, interval_s: float, segment_records: int, now: float
    ):
        self.dir = dir_path
        self.interval_s = interval_s
        self.segment_records = segment_records
        self.next_deadline = now + interval_s
        #: events already written to some segment
        self.flushed = 0
        self.seg_index = 0
        self.seg_path: Optional[str] = None
        self.seg_count = 0
        self.ticks = 0

    def segment_paths(self) -> List[str]:
        if not os.path.isdir(self.dir):
            return []
        return sorted(
            os.path.join(self.dir, n)
            for n in os.listdir(self.dir)
            if n.startswith("events-") and n.endswith(".jsonl")
        )


class Span:
    """One timed, parented region; records itself on ``__exit__``."""

    __slots__ = ("_tel", "id", "parent", "kind", "name", "attrs", "t0", "_prev")

    def __init__(
        self,
        tel: "Telemetry",
        span_id: int,
        parent: Optional[int],
        kind: str,
        name: str,
        attrs: Dict[str, Any],
    ):
        self._tel = tel
        self.id = span_id
        self.parent = parent
        self.kind = kind
        self.name = name
        self.attrs = attrs
        self.t0: Optional[float] = None
        self._prev: Optional[int] = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tel = self._tel
        tel._stack().append(self.id)
        if self.kind in _AMBIENT_KINDS:
            self._prev = tel._ambient
            tel._ambient = self.id
        self.t0 = tel.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tel = self._tel
        t1 = tel.clock()
        stack = tel._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        if self.kind in _AMBIENT_KINDS:
            tel._ambient = self._prev
        record: Dict[str, Any] = {
            "kind": "span",
            "id": self.id,
            "parent": self.parent,
            "span": self.kind,
            "name": self.name,
            "t0": self.t0,
            "dur_s": t1 - (self.t0 if self.t0 is not None else t1),
        }
        if exc_type is not None:
            record["status"] = "error"
            record["error"] = f"{exc_type.__name__}: {exc}"
        if self.attrs:
            record["attrs"] = self.attrs
        tel._append(record)


class Telemetry:
    """The per-run telemetry hub: spans + events + metrics registry."""

    def __init__(
        self,
        level: str = "off",
        *,
        run_id: Optional[str] = None,
        clock=None,
        export: bool = True,
    ):
        if level not in LEVELS:
            raise ValueError(f"obs level must be one of {LEVELS}, got {level!r}")
        self.level = level
        # the level never changes: its tests are plain attributes, read on
        # every recording call of the serve tier's hot path
        self._on = level != "off"
        self._trace = level in ("trace", "profile")
        self.run_id = run_id
        self.clock = time.monotonic if clock is None else clock
        #: write OpenMetrics text snapshots (``metrics.prom``) on flush
        self.export = export
        #: disabled-path activity counter — the ONLY state the off level
        #: touches, and the overhead-guard tests' zero-event witness
        self.suppressed = 0
        self._lock = threading.Lock()
        self._next_id = 0
        self._events: List[Dict[str, Any]] = []
        self._local = threading.local()
        self._ambient: Optional[int] = None
        self.metrics = MetricsRegistry(clock=self.clock)
        # name -> instrument memos over the registry (which stays the one
        # owner and type check): a hot-path call is one dict probe
        self._counters: Dict[str, Any] = {}
        self._gauges: Dict[str, Any] = {}
        self._hists: Dict[str, Any] = {}
        self._stream: Optional[_StreamSink] = None
        self._flush_lock = threading.Lock()
        self._listeners: List[Callable[["Telemetry"], None]] = []

    # ---------------------------------------------------------------- levels
    @property
    def enabled(self) -> bool:
        return self._on

    @property
    def trace_enabled(self) -> bool:
        return self._trace

    @property
    def profile_enabled(self) -> bool:
        return self.level == "profile"

    # ----------------------------------------------------------------- spans
    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _current_parent(self) -> Optional[int]:
        stack = self._stack()
        if stack:
            return stack[-1]
        return self._ambient

    def _alloc_id(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
        return i

    def _append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(record)

    def span(self, kind: str, name: Optional[str] = None, **attrs):
        """Open a structural span (recorded at every enabled level)."""
        if not self.enabled:
            self.suppressed += 1
            return _NULL_SPAN
        return Span(
            self, self._alloc_id(), self._current_parent(), kind, name or kind, attrs
        )

    def trace_span(self, kind: str, name: Optional[str] = None, **attrs):
        """A fine-grained span (superstep/batch/query): trace level only."""
        if not self.trace_enabled:
            if not self.enabled:
                self.suppressed += 1
            return _NULL_SPAN
        return self.span(kind, name, **attrs)

    def event(self, name: str, **attrs) -> None:
        """A point event under the current parent (any enabled level)."""
        if not self.enabled:
            self.suppressed += 1
            return
        record: Dict[str, Any] = {
            "kind": "event",
            "id": self._alloc_id(),
            "parent": self._current_parent(),
            "name": name,
            "t": self.clock(),
        }
        if attrs:
            record["attrs"] = attrs
        self._append(record)

    # --------------------------------------------------------------- metrics
    def count(self, name: str, n: int = 1) -> None:
        if not self._on:
            self.suppressed += 1
            return
        inst = self._counters.get(name)
        if inst is None:
            inst = self._counters[name] = self.metrics.counter(name)
        inst.value += n

    def gauge(self, name: str, value: float) -> None:
        if not self._on:
            self.suppressed += 1
            return
        inst = self._gauges.get(name)
        if inst is None:
            inst = self._gauges[name] = self.metrics.gauge(name)
        inst.set(value)

    def observe(self, name: str, value: float) -> None:
        if not self._on:
            self.suppressed += 1
            return
        inst = self._hists.get(name)
        if inst is None:
            inst = self._hists[name] = self.metrics.histogram(name)
        inst.observe(value)

    # ------------------------------------------------------------ inspection
    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the recorded span/event records (closed spans only)."""
        with self._lock:
            return list(self._events)

    def meta(self) -> Dict[str, Any]:
        return {
            "kind": "meta",
            "schema": SCHEMA,
            "run_id": self.run_id,
            "level": self.level,
        }

    def summary(self) -> Dict[str, Any]:
        from repro_torch.obs.summary import summarize

        return summarize(self.meta(), self.events(), self.metrics.to_lines())

    # ------------------------------------------------------------- streaming
    def attach_stream(
        self,
        dir_path: str,
        *,
        interval_s: float = 1.0,
        segment_records: int = 2048,
    ) -> bool:
        """Enable periodic incremental flush into ``dir_path``.

        After attaching, :meth:`maybe_flush` calls from producer pump
        points write one incremental tick per elapsed ``interval_s``.
        No-op (returns False) when the level is ``off``.
        """
        if not self.enabled:
            return False
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if segment_records < 1:
            raise ValueError(
                f"segment_records must be >= 1, got {segment_records}"
            )
        os.makedirs(dir_path, exist_ok=True)
        with self._flush_lock:
            self._stream = _StreamSink(
                dir_path, interval_s, segment_records, self.clock()
            )
        return True

    @property
    def streaming(self) -> bool:
        return self._stream is not None

    def add_flush_listener(self, fn: Callable[["Telemetry"], None]) -> None:
        """Register a per-tick callback (runs after each incremental
        write — the SLO watchdog's evaluation hook)."""
        self._listeners.append(fn)

    def remove_flush_listener(self, fn: Callable[["Telemetry"], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def maybe_flush(self) -> bool:
        """Incremental flush iff a stream is attached and its interval
        elapsed.  The no-stream path is one attribute test — cheap enough
        for per-tick / per-superstep pump points."""
        stream = self._stream
        if stream is None:
            return False
        if self.clock() < stream.next_deadline:
            return False
        return self.flush_tick()

    def flush_tick(self) -> bool:
        """Force one incremental streaming tick (segment append + atomic
        snapshot rotation + listeners).  Returns False when no stream is
        attached or another thread is mid-tick."""
        stream = self._stream
        if stream is None or not self.enabled:
            return False
        if not self._flush_lock.acquire(blocking=False):
            return False  # a concurrent producer is already flushing
        try:
            if self._stream is not stream:  # detached under our feet
                return False
            stream.next_deadline = self.clock() + stream.interval_s
            with self._lock:
                fresh = self._events[stream.flushed :]
                stream.flushed += len(fresh)
            if fresh:
                self._append_segment(stream, fresh)
            self._write_snapshots(stream.dir)
            stream.ticks += 1
        finally:
            self._flush_lock.release()
        # listeners run outside the flush lock: they record events and
        # metrics of their own (picked up by the NEXT tick) and may call
        # back into serve-side knobs
        for fn in list(self._listeners):
            fn(self)
        return True

    def _append_segment(
        self, stream: _StreamSink, records: List[Dict[str, Any]]
    ) -> None:
        """Append ``records`` to the live segment, rotating when full."""
        for record in records:
            if (
                stream.seg_path is None
                or stream.seg_count >= stream.segment_records
            ):
                stream.seg_index += 1
                stream.seg_path = os.path.join(
                    stream.dir, f"events-{stream.seg_index:04d}.jsonl"
                )
                stream.seg_count = 0
                with open(stream.seg_path, "w") as f:
                    f.write(json.dumps(self.meta(), sort_keys=True) + "\n")
            with open(stream.seg_path, "a") as f:
                f.write(json.dumps(record, sort_keys=True) + "\n")
            stream.seg_count += 1

    def _write_snapshots(self, dir_path: str) -> List[str]:
        """Atomically rotate metrics.jsonl / summary.json / metrics.prom."""
        meta = self.meta()
        lines = self.metrics.to_lines()
        paths = [
            _atomic_write(
                os.path.join(dir_path, "metrics.jsonl"),
                "".join(
                    json.dumps(r, sort_keys=True) + "\n"
                    for r in [meta] + lines
                ),
            ),
            _atomic_write(
                os.path.join(dir_path, "summary.json"),
                json.dumps(self.summary(), indent=2, sort_keys=True) + "\n",
            ),
        ]
        if self.export:
            from repro_torch.obs.export import render_openmetrics

            paths.append(
                _atomic_write(
                    os.path.join(dir_path, "metrics.prom"),
                    render_openmetrics(lines, meta=meta),
                )
            )
        return paths

    # ----------------------------------------------------------------- flush
    def flush(self, dir_path: str) -> List[str]:
        """Write the final ``events.jsonl`` / ``metrics.jsonl`` /
        ``summary.json`` (+ ``metrics.prom`` when exporting).

        Each JSONL file leads with a ``meta`` line carrying the schema
        version; returns the written paths ([] when disabled).  When a
        stream was attached to the same directory, its segments are
        consolidated: the complete event log replaces them, so the
        post-run layout matches a non-streaming run.
        """
        if not self.enabled:
            return []
        os.makedirs(dir_path, exist_ok=True)
        meta = self.meta()
        paths = []
        with self._flush_lock:
            stream, self._stream = self._stream, None  # detach: run is over
            events_path = os.path.join(dir_path, "events.jsonl")
            with open(events_path, "w") as f:
                for record in [meta] + self.events():
                    f.write(json.dumps(record, sort_keys=True) + "\n")
            paths.append(events_path)
            paths.extend(self._write_snapshots(dir_path))
            if stream is not None and os.path.realpath(
                stream.dir
            ) == os.path.realpath(dir_path):
                for seg in stream.segment_paths():
                    os.unlink(seg)
        return paths
