"""SLO watchdog: per-flush-window objective evaluation (DESIGN.md §14.9).

Declarative objectives (an ``ObsSpec.slo`` block) are evaluated against
*window deltas* of the metrics registry on every streaming flush tick:
the watchdog snapshots counters / histogram buckets / the residual gauge
per tick and scores each objective on the difference, so a long-running
serve replay is judged on its recent behavior, not its lifetime
averages.  The alerting policy is multi-window burn rate:

* a window **burns** when any configured objective is violated in it;
* ``burn_windows`` *consecutive* burning windows raise a **breach** —
  an ``obs.slo.breach`` event, the ``obs.slo.breaches`` counter, and
  one rung of the degradation ladder;
* while breached, every further ``burn_windows`` burning windows climb
  the next rung;
* ``recovery_windows`` consecutive clean windows emit
  ``obs.slo.recovery`` and restore every degraded knob.

:class:`ServeDegradation` is the serve-side hook the breach callback
drives, over the two knobs that already exist in the tier: first shed
the ``bulk`` admission fraction (``MicroBatcher.set_admit_fraction`` —
backfill load rejects at the edge, interactive traffic keeps its
budget), then widen the early-exit σ
(``LPServeEngine.set_sigma_scale`` — cheaper, coarser solves).  Both
restore exactly on recovery.

Everything is deterministic under an injected clock: the watchdog never
reads time itself — windows are whatever the telemetry flush ticks say
they are.  Import-light on purpose (no torch, no numpy, no api imports —
the spec layer hands over plain attributes via :meth:`SLOWatchdog.from_spec`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import Counter, Gauge, Histogram

#: counters the window delta tracks
_COUNTERS = (
    "serve.completed",
    "serve.failed",
    "serve.rejected",
    "serve.cache.hits",
    "serve.cache.misses",
)

#: degradation rungs, in escalation order
LADDER = ("shed_bulk", "widen_sigma")


class ServeDegradation:
    """The serve tier's two-rung degradation ladder.

    ``bulk_fraction`` is the shed target for the bulk admission share
    (rung 1); ``sigma_scale`` the early-exit widening factor (rung 2).
    ``escalate()`` climbs one rung per call and returns the action name
    (None once the ladder is exhausted); ``restore()`` resets every
    engaged knob and returns the actions undone.
    """

    def __init__(
        self,
        engine,
        *,
        bulk_fraction: float = 0.1,
        sigma_scale: float = 4.0,
    ):
        if not 0.0 < bulk_fraction <= 1.0:
            raise ValueError(
                f"bulk_fraction must be in (0, 1], got {bulk_fraction}"
            )
        if sigma_scale < 1.0:
            raise ValueError(f"sigma_scale must be >= 1.0, got {sigma_scale}")
        self._engine = engine
        self._bulk_fraction = bulk_fraction
        self._sigma_scale = sigma_scale
        self._base_bulk = engine.batcher.admit_fraction("bulk")
        self.level = 0

    def escalate(self) -> Optional[str]:
        if self.level >= len(LADDER):
            return None
        action = LADDER[self.level]
        if action == "shed_bulk":
            self._engine.batcher.set_admit_fraction(
                "bulk", min(self._bulk_fraction, self._base_bulk)
            )
        else:  # widen_sigma
            self._engine.set_sigma_scale(self._sigma_scale)
        self.level += 1
        return action

    def restore(self) -> List[str]:
        undone = list(LADDER[: self.level])
        if self.level >= 2:
            self._engine.set_sigma_scale(1.0)
        if self.level >= 1:
            self._engine.batcher.set_admit_fraction("bulk", self._base_bulk)
        self.level = 0
        return undone


class SLOWatchdog:
    """Multi-window burn-rate evaluation over the metrics registry."""

    def __init__(
        self,
        telemetry,
        *,
        latency_p95_ms: Optional[float] = None,
        error_rate: Optional[float] = None,
        cache_hit_floor: Optional[float] = None,
        stall_windows: Optional[int] = None,
        burn_windows: int = 3,
        recovery_windows: int = 2,
        degradation: Optional[ServeDegradation] = None,
        latency_metric: str = "serve.latency_s",
    ):
        if burn_windows < 1:
            raise ValueError(f"burn_windows must be >= 1, got {burn_windows}")
        if recovery_windows < 1:
            raise ValueError(
                f"recovery_windows must be >= 1, got {recovery_windows}"
            )
        self._tel = telemetry
        self.latency_p95_ms = latency_p95_ms
        self.error_rate = error_rate
        self.cache_hit_floor = cache_hit_floor
        self.stall_windows = stall_windows
        self.burn_windows = burn_windows
        self.recovery_windows = recovery_windows
        self.degradation = degradation
        self.latency_metric = latency_metric
        self._prev: Optional[Dict[str, Any]] = None
        self._residual_history: List[Optional[float]] = []
        self._consecutive_burn = 0
        self._consecutive_ok = 0
        self.breached = False
        self.breaches = 0
        self.recoveries = 0
        self.windows = 0
        self.history: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def from_spec(
        cls, slo, telemetry, *, degradation: Optional[ServeDegradation] = None
    ) -> "SLOWatchdog":
        """Build from any object carrying the ``ObsSpec.slo`` attributes
        (the api layer's ``SLOSpec`` — duck-typed so obs never imports
        the spec module)."""
        return cls(
            telemetry,
            latency_p95_ms=getattr(slo, "latency_p95_ms", None),
            error_rate=getattr(slo, "error_rate", None),
            cache_hit_floor=getattr(slo, "cache_hit_floor", None),
            stall_windows=getattr(slo, "stall_windows", None),
            burn_windows=getattr(slo, "burn_windows", 3),
            recovery_windows=getattr(slo, "recovery_windows", 2),
            degradation=degradation,
        )

    def attach(self) -> "SLOWatchdog":
        """Register on the telemetry's flush tick (one eval per window)."""
        self._tel.add_flush_listener(self._on_flush)
        return self

    def detach(self) -> None:
        self._tel.remove_flush_listener(self._on_flush)

    def _on_flush(self, _tel) -> None:
        self.evaluate()

    # ------------------------------------------------------------ snapshots
    def _snapshot(self) -> Dict[str, Any]:
        reg = self._tel.metrics
        snap: Dict[str, Any] = {"counters": {}}
        for name in _COUNTERS:
            inst = reg.peek(name)
            snap["counters"][name] = (
                inst.value if isinstance(inst, Counter) else 0
            )
        hist = reg.peek(self.latency_metric)
        if isinstance(hist, Histogram):
            snap["hist_counts"] = list(hist.counts)
            snap["hist_edges"] = hist.edges
            snap["hist_max"] = hist.max
        residual = reg.peek("solve.residual")
        if isinstance(residual, Gauge) and residual.series:
            snap["residual"] = (len(residual.series), residual.series[-1][1])
        return snap

    def _window_p95(
        self, prev: Dict[str, Any], cur: Dict[str, Any]
    ) -> Optional[float]:
        """p95 of THIS window's latency observations (bucket-delta walk —
        the histogram-mergeability contract run in reverse)."""
        if "hist_counts" not in cur:
            return None
        prev_counts = prev.get("hist_counts") or [0] * len(cur["hist_counts"])
        delta = [c - p for c, p in zip(cur["hist_counts"], prev_counts)]
        n = sum(delta)
        if n <= 0:
            return None
        target = 0.95 * n
        cum = 0
        for i, c in enumerate(delta):
            cum += c
            if cum >= target:
                if i < len(cur["hist_edges"]):
                    return float(cur["hist_edges"][i])
                return float(cur["hist_max"])  # overflow bucket
        return float(cur["hist_max"])

    # ------------------------------------------------------------ evaluation
    def evaluate(self) -> Dict[str, Any]:
        """Score one window; fires breach/recovery as thresholds cross."""
        cur = self._snapshot()
        if self._prev is None:
            # the first tick only anchors the window arithmetic
            self._prev = cur
            return {"window": 0, "burning": False, "violations": []}
        prev, self._prev = self._prev, cur
        self.windows += 1
        violations: List[Dict[str, Any]] = []

        def delta(name: str) -> int:
            return cur["counters"][name] - prev["counters"][name]

        if self.latency_p95_ms is not None:
            p95 = self._window_p95(prev, cur)
            if p95 is not None and p95 * 1e3 > self.latency_p95_ms:
                violations.append(
                    {
                        "objective": "latency_p95_ms",
                        "observed": p95 * 1e3,
                        "threshold": self.latency_p95_ms,
                    }
                )
        if self.error_rate is not None:
            errors = delta("serve.failed") + delta("serve.rejected")
            total = errors + delta("serve.completed")
            if total > 0 and errors / total > self.error_rate:
                violations.append(
                    {
                        "objective": "error_rate",
                        "observed": errors / total,
                        "threshold": self.error_rate,
                    }
                )
        if self.cache_hit_floor is not None:
            hits = delta("serve.cache.hits")
            lookups = hits + delta("serve.cache.misses")
            if lookups > 0 and hits / lookups < self.cache_hit_floor:
                violations.append(
                    {
                        "objective": "cache_hit_floor",
                        "observed": hits / lookups,
                        "threshold": self.cache_hit_floor,
                    }
                )
        if self.stall_windows is not None:
            self._residual_history.append(
                cur["residual"][1]
                if "residual" in cur
                and ("residual" not in prev or cur["residual"][0] > prev["residual"][0])
                else None
            )
            tail = self._residual_history[-(self.stall_windows + 1) :]
            if len(tail) == self.stall_windows + 1 and all(
                v is not None for v in tail
            ):
                # the solve kept stepping for stall_windows windows
                # without the residual improving: convergence stall
                if min(tail[1:]) >= tail[0]:
                    violations.append(
                        {
                            "objective": "convergence_stall",
                            "observed": tail[-1],
                            "threshold": tail[0],
                        }
                    )

        burning = bool(violations)
        if burning:
            self._consecutive_burn += 1
            self._consecutive_ok = 0
        else:
            self._consecutive_ok += 1
            self._consecutive_burn = 0
        self._tel.gauge("obs.slo.burning", 1.0 if burning else 0.0)

        action = None
        if burning and self._consecutive_burn % self.burn_windows == 0:
            # every burn_windows consecutive burning windows: breach (the
            # first time) then one more degradation rung per recurrence
            if not self.breached:
                self.breached = True
                self.breaches += 1
            if self.degradation is not None:
                action = self.degradation.escalate()
            self._tel.count("obs.slo.breaches")
            self._tel.event(
                "obs.slo.breach",
                window=self.windows,
                consecutive=self._consecutive_burn,
                violations=violations,
                action=action,
            )
        elif (
            self.breached and self._consecutive_ok >= self.recovery_windows
        ):
            self.breached = False
            self.recoveries += 1
            restored = (
                self.degradation.restore()
                if self.degradation is not None
                else []
            )
            self._tel.count("obs.slo.recoveries")
            self._tel.event(
                "obs.slo.recovery",
                window=self.windows,
                clean_windows=self._consecutive_ok,
                restored=restored,
            )

        result = {
            "window": self.windows,
            "burning": burning,
            "violations": violations,
            "breached": self.breached,
            "action": action,
        }
        self.history.append(result)
        return result

    # --------------------------------------------------------------- report
    def report(self) -> Dict[str, Any]:
        """Artifact-ready roll-up (lands in the serve report's slo block)."""
        return {
            "windows": self.windows,
            "breaches": self.breaches,
            "recoveries": self.recoveries,
            "breached": self.breached,
            "degradation_level": (
                self.degradation.level if self.degradation is not None else 0
            ),
            "objectives": {
                k: v
                for k, v in (
                    ("latency_p95_ms", self.latency_p95_ms),
                    ("error_rate", self.error_rate),
                    ("cache_hit_floor", self.cache_hit_floor),
                    ("stall_windows", self.stall_windows),
                )
                if v is not None
            },
            "burn_windows": self.burn_windows,
            "recovery_windows": self.recovery_windows,
        }
