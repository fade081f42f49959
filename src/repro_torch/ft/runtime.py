"""Fault-tolerance runtime: failure handling, straggler watch, retries.

On a 1000+-node cluster the failure model is: a worker dies mid-step
(preemption, HBM ECC, network partition) or slows down (straggler).  The
driver-side mechanisms here are platform-agnostic:

* ``StepGuard`` — wraps the train step; classifies exceptions as
  retryable (transient runtime errors) vs fatal (shape/compile bugs),
  retries with backoff, and after ``max_retries`` restores from the last
  checkpoint and replays.
* ``StragglerWatch`` — EWMA of step times; flags steps slower than
  ``threshold ×`` the running mean.  In the LP engine the mitigation is
  bounded staleness (``ShardedHeteroLP(stale_sync=k)``); in a training
  loop it feeds the elastic controller below.
* ``ElasticController`` — decides on re-meshing when the healthy device
  count changes; checkpoints are saved unsharded, so a restore onto the
  new mesh is ``CheckpointManager.restore(..., shardings=new)``
  (:func:`repro_torch.ft.elastic.remesh` runs it end to end).
* ``FailureInjector`` — deterministic fault injection for tests: raises a
  transient error on chosen steps so CI can exercise the recovery path.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

PyTree = Any


class TransientWorkerError(RuntimeError):
    """A failure that a retry / restore-replay can heal."""


_RETRYABLE = (TransientWorkerError,)
_RETRYABLE_MESSAGES = (
    "DATA_LOSS", "UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED",
    "socket closed", "connection reset",
)


def is_retryable(err: BaseException) -> bool:
    if isinstance(err, _RETRYABLE):
        return True
    msg = str(err)
    return any(tag in msg for tag in _RETRYABLE_MESSAGES)


@dataclasses.dataclass
class StragglerWatch:
    """EWMA step timer; flags outliers (the paper's fig. 4 problem: one
    slow worker gates every BSP superstep).

    With ``telemetry`` set, every flagged step bumps the
    ``ft.straggler_flags`` counter and each observation refreshes the
    ``ft.step_time_mean`` gauge, so the SLO watchdog can alert on
    straggler rate without polling this object.
    """

    alpha: float = 0.1
    threshold: float = 2.0
    _mean: Optional[float] = None
    slow_steps: int = 0
    telemetry: Optional[Any] = None

    def observe(self, step_time: float) -> bool:
        if self._mean is None:
            self._mean = step_time
            if self.telemetry is not None:
                self.telemetry.gauge("ft.step_time_mean", self._mean)
            return False
        is_slow = step_time > self.threshold * self._mean
        if is_slow:
            self.slow_steps += 1
            if self.telemetry is not None:
                self.telemetry.count("ft.straggler_flags")
        # slow steps perturb the mean less (they are the anomaly)
        a = self.alpha * (0.25 if is_slow else 1.0)
        self._mean = (1 - a) * self._mean + a * step_time
        if self.telemetry is not None:
            self.telemetry.gauge("ft.step_time_mean", self._mean)
        return is_slow

    @property
    def mean_step_time(self) -> Optional[float]:
        return self._mean


@dataclasses.dataclass
class FailureInjector:
    """Raise a transient error at the given steps (tests/chaos drills)."""

    fail_at: Tuple[int, ...] = ()
    fired: List[int] = dataclasses.field(default_factory=list)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise TransientWorkerError(f"injected fault at step {step}")


@dataclasses.dataclass
class StepGuard:
    """Retry/restore wrapper around one step of work.

    Transient failures retry with exponential backoff; once the retry
    budget is spent, ``restore_fn`` (if any) rolls state back to the last
    checkpoint and the replay re-enters the *same* guarded loop with a
    fresh budget — a transient fault during the replay is retried, not
    propagated.  One restore per ``run`` call: exhausting the budget a
    second time re-raises the last error.

    ``sleep`` is the backoff clock — injectable so tests (and simulated
    time) never wall-sleep.  With ``telemetry`` set, retries and restores
    bump the ``ft.retries`` / ``ft.restores`` counters.
    """

    max_retries: int = 3
    backoff_s: float = 0.05
    restore_fn: Optional[Callable[[], Tuple[int, PyTree]]] = None
    retries: int = 0
    restores: int = 0
    sleep: Callable[[float], None] = time.sleep
    telemetry: Optional[Any] = None

    def run(self, step_fn: Callable[[], PyTree]) -> PyTree:
        last: Optional[BaseException] = None
        attempt = 0
        restored = False
        while True:
            try:
                return step_fn()
            except BaseException as e:  # noqa: BLE001
                if not is_retryable(e):
                    raise
                last = e
                if attempt < self.max_retries:
                    self.retries += 1
                    if self.telemetry is not None:
                        self.telemetry.count("ft.retries")
                    self.sleep(self.backoff_s * (2 ** attempt))
                    attempt += 1
                    continue
                if self.restore_fn is not None and not restored:
                    restored = True
                    self.restores += 1
                    if self.telemetry is not None:
                        self.telemetry.count("ft.restores")
                    self.restore_fn()
                    attempt = 0  # the replay gets a fresh retry budget
                    continue
                raise last


@dataclasses.dataclass
class ElasticController:
    """Re-mesh policy: checkpoint → rebuild the mesh on the healthy devices
    → restore with new shardings.  Device loss detection is platform-level;
    here is the decision and its bookkeeping."""

    min_devices: int = 1
    history: List[Dict] = dataclasses.field(default_factory=list)

    def plan(self, healthy_devices: int, current_devices: int) -> Optional[Dict]:
        if healthy_devices == current_devices:
            return None
        if healthy_devices < self.min_devices:
            raise RuntimeError(
                f"{healthy_devices} devices < minimum {self.min_devices}"
            )
        # shrink to the largest power-of-two ≤ healthy (keeps meshes tidy)
        target = 1
        while target * 2 <= healthy_devices:
            target *= 2
        plan = {
            "from": current_devices,
            "to": target,
            "action": "checkpoint-restore-reshard",
        }
        self.history.append(plan)
        return plan
