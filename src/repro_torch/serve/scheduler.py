"""Pipelined micro-batching scheduler (DESIGN.md §9.1).

Independent queries are embarrassingly batchable in LP: each is one seed
column, and the solver already iterates whole column-blocks per round.
The serving tick is: drain up to ``max_batch`` pending requests (waiting
at most ``max_wait_s`` for stragglers to coalesce), stack their seed
columns, run ONE batched solve, scatter results back to per-request
futures.

Three layers on top of that basic tick:

* **Priority classes + admission control.**  Requests carry a class
  (``interactive`` > ``refresh`` > ``bulk``).  Admission is the bounded
  queue with class-dependent thresholds: lower classes shed load earlier
  (``ADMIT_FRACTION`` of ``queue_depth``), so a bulk backfill can never
  push interactive traffic into rejection.  Draining is weighted
  round-robin (``DRAIN_WEIGHTS``): every tick reserves at least one slot
  for each non-empty class, so low-priority work is throttled, never
  starved.
* **Pipelining.**  With ``pipeline_depth > 1`` and the two-stage hooks
  (``assemble``/``execute``), ``start()`` runs a *collector* thread that
  coalesces and assembles the next batch (cache probes, seed-matrix
  construction) while a *solver* thread runs the engine on the current
  one.  The bounded in-flight queue (``pipeline_depth - 1`` assembled
  batches plus the one being solved) is the double-buffer window —
  assembly and solve overlap, memory stays bounded.
* **Backpressure.**  A full class budget makes ``submit`` block
  (default) or raise ``queue.Full`` — the caller sheds load instead of
  the engine dying.

With a ``telemetry`` handle attached (DESIGN.md §14) each tick records
queue depth (total and per class), in-flight depth per class, batch
size/occupancy gauges and batch/completed/failed counters; at trace
level the tick itself becomes a ``batch`` span with per-query events.
The batcher runs on background threads, so those spans parent to the
Session's *ambient* phase span, not a stack frame of this thread.
"""
from __future__ import annotations

import contextlib

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.serve.types import (
    DEFAULT_PRIORITY,
    PRIORITY_CLASSES,
    QueryResult,
    QuerySpec,
)

# solve_batch: List[QuerySpec] -> List[QueryResult] (same order)
SolveBatchFn = Callable[[Sequence[QuerySpec]], List[QueryResult]]

#: Admission thresholds: a class is admitted while total pending is below
#: ``ADMIT_FRACTION[cls] * queue_depth``.  Interactive may fill the whole
#: queue; refresh and bulk shed earlier, in that order.
ADMIT_FRACTION: Dict[str, float] = {
    "interactive": 1.0,
    "refresh": 0.75,
    "bulk": 0.5,
}

#: Weighted round-robin drain shares.  Each tick grants every non-empty
#: class at least one slot (anti-starvation), then splits the batch
#: roughly proportionally to these weights, then backfills by priority.
DRAIN_WEIGHTS: Dict[str, int] = {
    "interactive": 8,
    "refresh": 4,
    "bulk": 2,
}

_Entry = Tuple[QuerySpec, "queue.Future", float]  # (spec, future, t_submit)


@dataclasses.dataclass
class SchedulerStats:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    batches: int = 0
    by_class: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {
            c: {"submitted": 0, "completed": 0, "rejected": 0}
            for c in PRIORITY_CLASSES
        }
    )

    @property
    def mean_batch_size(self) -> float:
        return self.completed / self.batches if self.batches else 0.0


class _PipelineItem:
    """An assembled batch waiting for (or undergoing) its solve."""

    __slots__ = ("prepared", "live")

    def __init__(self, prepared: Any, live: List[_Entry]):
        self.prepared = prepared
        self.live = live


_SENTINEL = object()


class MicroBatcher:
    """Coalesce pending queries into batched solves, optionally pipelined.

    ``solve_batch`` is the one-stage callback (assemble + solve + rank in
    one call) used by the synchronous paths (``run_once``/``drain``) and
    by the legacy background loop.  Passing the two-stage hooks
    ``assemble`` (queue-side: cache probes + seed assembly, cheap) and
    ``execute`` (engine-side: the batched solve + ranking, the long pole)
    with ``pipeline_depth > 1`` makes ``start()`` run the pipelined
    collector/solver pair instead.
    """

    def __init__(
        self,
        solve_batch: SolveBatchFn,
        *,
        max_batch: int = 64,
        max_wait_s: float = 0.005,
        queue_depth: int = 1024,
        pipeline_depth: int = 1,
        assemble: Optional[Callable[[Sequence[QuerySpec]], Any]] = None,
        execute: Optional[Callable[[Any], List[QueryResult]]] = None,
        telemetry=None,
        guard=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if pipeline_depth > 1 and (assemble is None or execute is None):
            raise ValueError(
                "pipeline_depth > 1 needs the two-stage assemble/execute "
                "hooks (the one-stage solve_batch cannot overlap)"
            )
        self._solve_batch = solve_batch
        self._assemble = assemble
        self._execute = execute
        self._tel = telemetry
        # optional repro_torch.ft.StepGuard: solver-side batch execution runs
        # inside it, so a transient engine fault retries (and, with a
        # restore_fn wired, restores + replays the in-flight batch)
        # instead of failing every co-batched future.  Public so the
        # serve engine's FT wiring can attach one after construction.
        self.guard = guard
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.queue_depth = queue_depth
        self.pipeline_depth = pipeline_depth
        self._classes: Dict[str, "deque[_Entry]"] = {
            c: deque() for c in PRIORITY_CLASSES
        }
        # per-class gauge names, built once instead of on every tick
        self._depth_names = {c: f"serve.queue_depth.{c}" for c in PRIORITY_CLASSES}
        self._inflight_names: Dict[str, str] = {}
        self._pending_count = 0
        self._cond = threading.Condition()
        # per-instance so the SLO degradation hook can shed a class's
        # share at runtime (set_admit_fraction) without touching the
        # module-level policy defaults
        self._admit_fraction = dict(ADMIT_FRACTION)
        self._admit_limit = {
            c: max(1, int(queue_depth * self._admit_fraction[c]))
            for c in PRIORITY_CLASSES
        }
        self.stats = SchedulerStats()
        self._stats_lock = threading.Lock()
        # assembled-but-unsolved batches; the +1 batch inside execute()
        # completes the pipeline_depth-deep in-flight window
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=max(1, pipeline_depth - 1)
        )
        self._inflight_by_class: Dict[str, int] = dict.fromkeys(
            PRIORITY_CLASSES, 0
        )
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # ------------------------------------------------------------ producers
    def submit(
        self,
        spec: QuerySpec,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> "queue.Future":
        """Enqueue a query; the future resolves after some later tick.

        Admission control: the request's priority class is admitted while
        total pending sits below its share of ``queue_depth``.  Over
        budget, ``block=False`` (or a timeout) raises ``queue.Full`` —
        that is the backpressure signal, and lower classes hit it first.
        """
        from concurrent.futures import Future

        cls = getattr(spec, "priority", DEFAULT_PRIORITY)
        if cls not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {cls!r}; classes: {PRIORITY_CLASSES}"
            )
        fut: "Future[QueryResult]" = Future()
        limit = self._admit_limit[cls]
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending_count >= limit:
                if not block:
                    self._reject(cls)
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    self._reject(cls)
                if not self._cond.wait(timeout=remaining):
                    self._reject(cls)
            self._classes[cls].append((spec, fut, time.monotonic()))
            self._pending_count += 1
            self._cond.notify_all()
        with self._stats_lock:
            self.stats.submitted += 1
            self.stats.by_class[cls]["submitted"] += 1
        return fut

    def _reject(self, cls: str) -> None:
        with self._stats_lock:
            self.stats.rejected += 1
            self.stats.by_class[cls]["rejected"] += 1
        if self._tel is not None:
            self._tel.count("serve.rejected")
            self._tel.count(f"serve.rejected.{cls}")
        raise queue.Full

    # ------------------------------------------------- admission degradation
    def admit_fraction(self, cls: str) -> float:
        """The current admission share for ``cls`` (1.0 = whole queue)."""
        if cls not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {cls!r}; classes: {PRIORITY_CLASSES}"
            )
        with self._cond:
            return self._admit_fraction[cls]

    def set_admit_fraction(self, cls: str, fraction: float) -> None:
        """Runtime admission-control knob (the SLO degradation hook).

        Shrinking a class's fraction sheds its load at the admission
        edge — over-budget submits reject/block immediately; growing it
        back wakes blocked producers.  The limit floor of 1 mirrors
        ``__init__``: no class is ever fully shut off.
        """
        if cls not in PRIORITY_CLASSES:
            raise ValueError(
                f"unknown priority {cls!r}; classes: {PRIORITY_CLASSES}"
            )
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"admit fraction must be in (0, 1], got {fraction}"
            )
        with self._cond:
            self._admit_fraction[cls] = float(fraction)
            self._admit_limit[cls] = max(1, int(self.queue_depth * fraction))
            self._cond.notify_all()  # a raised limit unblocks waiters
        if self._tel is not None:
            self._tel.gauge(f"serve.admit_limit.{cls}", self._admit_limit[cls])

    @property
    def pending(self) -> int:
        with self._cond:
            return self._pending_count

    def pending_by_class(self) -> Dict[str, int]:
        with self._cond:
            return {c: len(q) for c, q in self._classes.items()}

    # ------------------------------------------------------------- consumer
    def _collect(self, wait: bool) -> List[_Entry]:
        """Drain up to ``max_batch`` requests for one tick.

        Blocks up to ``max(max_wait_s, 0.05)`` for the FIRST request
        (when ``wait``), then keeps the straggler window open for
        ``max_wait_s`` — the batch closes when ``max_batch`` requests are
        pending or the window expires.  Selection is weighted round-robin
        across priority classes (see :data:`DRAIN_WEIGHTS`).
        """
        with self._cond:
            if not self._pending_count:
                if not wait:
                    return []
                self._cond.wait(timeout=max(self.max_wait_s, 0.05))
                if not self._pending_count:
                    return []
            deadline = time.monotonic() + self.max_wait_s
            while self._pending_count < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            return self._take_locked()

    def _take_locked(self) -> List[_Entry]:
        """WRR batch selection; caller holds ``self._cond``."""
        batch: List[_Entry] = []
        nonempty = [c for c in PRIORITY_CLASSES if self._classes[c]]
        total_w = sum(DRAIN_WEIGHTS[c] for c in nonempty) or 1
        # quota pass: every non-empty class gets >= 1 slot, roughly its
        # weighted share — bulk is throttled, never starved
        for c in nonempty:
            quota = max(1, (self.max_batch * DRAIN_WEIGHTS[c]) // total_w)
            q = self._classes[c]
            take = min(quota, len(q), self.max_batch - len(batch))
            for _ in range(take):
                batch.append(q.popleft())
        # fill pass: leftover room by priority order
        for c in PRIORITY_CLASSES:
            q = self._classes[c]
            while q and len(batch) < self.max_batch:
                batch.append(q.popleft())
        self._pending_count -= len(batch)
        self._cond.notify_all()
        return batch

    def _begin_batch(self, batch: List[_Entry]) -> List[_Entry]:
        """Transition futures to RUNNING, dropping cancelled requests.

        Crucially this makes later ``cancel()`` impossible — the
        ``set_result`` in completion can then never race a concurrent
        cancellation into ``InvalidStateError`` (which would kill the
        background loop).
        """
        return [
            (s, f, t) for (s, f, t) in batch
            if f.set_running_or_notify_cancel()
        ]

    def _record_tick(self, live: List[_Entry]) -> None:
        tel = self._tel
        if tel is None:
            return
        with self._cond:
            depth = self._pending_count
            per_class = {c: len(q) for c, q in self._classes.items()}
        tel.gauge("serve.queue_depth", depth)
        names = self._depth_names
        for c, d in per_class.items():
            tel.gauge(names.get(c) or f"serve.queue_depth.{c}", d)
        tel.gauge("serve.batch_size", len(live))
        tel.gauge("serve.batch_occupancy", len(live) / self.max_batch)
        # the scheduler tick is the serve tier's streaming pump: one
        # attribute test when no stream is attached (DESIGN.md §14.7)
        tel.maybe_flush()

    def _track_inflight(self, live: List[_Entry], delta: int) -> None:
        tel = self._tel
        with self._stats_lock:
            for spec, _, _ in live:
                cls = getattr(spec, "priority", DEFAULT_PRIORITY)
                self._inflight_by_class[cls] += delta
            snapshot = dict(self._inflight_by_class) if tel else None
        if tel is not None:
            names = self._inflight_names
            for c, n in snapshot.items():
                name = names.get(c)
                if name is None:
                    name = names[c] = f"serve.inflight.{c}"
                tel.gauge(name, n)

    def _complete(self, live: List[_Entry], results: List[QueryResult]) -> None:
        now = time.monotonic()
        tel = self._tel
        for (spec, fut, t_in), res in zip(live, results):
            res.latency_s = now - t_in
            fut.set_result(res)
            if tel is not None:
                # recorded at completion time (not post-replay) so the
                # latency histogram fills live — per-window SLO evaluation
                # and `repro obs --follow` read it mid-run
                tel.observe("serve.latency_s", res.latency_s)
            if tel is not None and tel.trace_enabled:
                tel.event(
                    "serve.query",
                    entity=spec.entity,
                    target_type=spec.target_type,
                    source=res.source,
                    rounds=res.rounds,
                    latency_s=res.latency_s,
                )
        with self._stats_lock:
            self.stats.completed += len(live)
            self.stats.batches += 1
            for spec, _, _ in live:
                cls = getattr(spec, "priority", DEFAULT_PRIORITY)
                self.stats.by_class[cls]["completed"] += 1
        if tel is not None:
            tel.count("serve.batches")
            tel.count("serve.completed", len(live))

    def _fail(self, live: List[_Entry], exc: BaseException) -> None:
        for _, fut, _ in live:
            fut.set_exception(exc)
        with self._stats_lock:
            self.stats.failed += len(live)
            self.stats.batches += 1
        if self._tel is not None:
            self._tel.count("serve.batches")
            self._tel.count("serve.failed", len(live))

    def _run_guarded(self, fn, arg):
        """Route one batch execution through the step guard, if any."""
        if self.guard is None:
            return fn(arg)
        return self.guard.run(lambda: fn(arg))

    def run_once(self, wait: bool = True) -> int:
        """One synchronous scheduler tick: coalesce → solve → resolve.

        Returns the number of requests served (0 when idle).
        """
        batch = self._collect(wait)
        if not batch:
            return 0
        live = self._begin_batch(batch)
        if not live:
            return 0
        specs = [s for s, _, _ in live]
        tel = self._tel
        self._record_tick(live)
        if tel is None:
            span = contextlib.nullcontext()
        else:
            span = tel.trace_span("batch", f"batch:{self.stats.batches}")
        with span:
            try:
                results = self._run_guarded(self._solve_batch, specs)
                if len(results) != len(specs):
                    raise RuntimeError(
                        f"solve_batch returned {len(results)} results for "
                        f"{len(specs)} specs"
                    )
            except Exception as exc:  # noqa: BLE001 — propagate to every waiter
                self._fail(live, exc)
                return 0
            self._complete(live, results)
        return len(live)

    def drain(self) -> int:
        """Serve until the queue is empty (synchronous drivers, tests)."""
        total = 0
        while True:
            served = self.run_once(wait=False)
            if served == 0 and self.pending == 0:
                return total
            total += served

    # ------------------------------------------------------ background loops
    @property
    def pipelined(self) -> bool:
        """Whether ``start()`` runs the two-stage collector/solver pair."""
        return (
            self.pipeline_depth > 1
            and self._assemble is not None
            and self._execute is not None
        )

    def start(self) -> None:
        if self._threads:
            return
        self._stop.clear()
        if self.pipelined:
            targets = [
                (self._collector_loop, "lp-serve-collector"),
                (self._solver_loop, "lp-serve-solver"),
            ]
        else:
            targets = [(self._legacy_loop, "lp-serve-batcher")]
        for target, name in targets:
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def _legacy_loop(self) -> None:
        while not self._stop.is_set():
            self.run_once(wait=True)

    def _collector_loop(self) -> None:
        """Stage 1: coalesce + assemble the NEXT batch while stage 2 solves.

        The blocking put on the bounded in-flight queue is the pipeline's
        flow control: at most ``pipeline_depth`` batches exist between
        assembly start and future resolution.
        """
        while not self._stop.is_set():
            batch = self._collect(wait=True)
            if not batch:
                continue
            live = self._begin_batch(batch)
            if not live:
                continue
            specs = [s for s, _, _ in live]
            self._record_tick(live)
            try:
                prepared = self._assemble(specs)
            except Exception as exc:  # noqa: BLE001 — fail this batch only
                self._fail(live, exc)
                continue
            self._track_inflight(live, +1)
            # blocks while the solver is pipeline_depth-1 batches behind;
            # the solver keeps consuming until the sentinel, so this put
            # always completes even during shutdown
            self._inflight.put(_PipelineItem(prepared, live))
        self._inflight.put(_SENTINEL)

    def _solver_loop(self) -> None:
        """Stage 2: execute assembled batches until the sentinel."""
        tel = self._tel
        while True:
            item = self._inflight.get()
            if item is _SENTINEL:
                return
            if tel is None:
                span = contextlib.nullcontext()
            else:
                span = tel.trace_span("batch", f"batch:{self.stats.batches}")
            with span:
                try:
                    results = self._run_guarded(self._execute, item.prepared)
                    if len(results) != len(item.live):
                        raise RuntimeError(
                            f"execute returned {len(results)} results for "
                            f"{len(item.live)} specs"
                        )
                except Exception as exc:  # noqa: BLE001
                    self._fail(item.live, exc)
                else:
                    self._complete(item.live, results)
            self._track_inflight(item.live, -1)

    def stop(self, timeout: float = 5.0) -> None:
        """Clean shutdown: in-flight batches finish, late submissions drain.

        Ordering: the collector observes the stop flag, pushes its final
        assembled batch (if any) plus the sentinel; the solver executes
        everything up to the sentinel and exits; whatever was submitted
        after the collector's last tick is drained synchronously.  No
        future is ever stranded.
        """
        if not self._threads:
            return
        self._stop.set()
        with self._cond:
            self._cond.notify_all()  # wake a collector blocked in _collect
        for t in self._threads:
            t.join(timeout)
        self._threads = []
        self.drain()  # don't strand late submissions
