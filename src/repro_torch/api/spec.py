"""Declarative run specification (DESIGN.md §13).

One serializable job description composing *network × algorithm ×
backend × eval × serve × bench*: a :class:`RunSpec` is a small dataclass
tree with strict validation (unknown keys and conflicting fields are
errors, not silent defaults) and a lossless JSON round-trip
(``RunSpec.from_json(spec.to_json()) == spec``).  The schema, the
validation messages and the spec hash are those of ``repro.api.spec``,
so the same JSON files run on both packages.

The tree is deliberately import-light — no torch, no numpy — so specs can
be parsed, validated, and diffed without touching an accelerator
runtime.  Registry-dependent checks (is ``backend`` a registered engine
key? is ``trace`` a known arrival process?) happen when a
:class:`~repro_torch.api.session.Session` resolves the spec.

Sections:

* :class:`NetworkSpec` — what graph: a named scenario, the drugnet case
  study, or an ``.npz`` file;
* :class:`SolveSpec`   — how to propagate: alg / backend / tolerance /
  momentum, plus the ranking the solve artifact reports;
* :class:`EvalSpec`    — optional scoring protocol (recovery or k-fold
  CV against planted truth);
* :class:`ServeSpec`   — optional online workload (trace replay or
  synthetic zipf) played against the serve stack;
* :class:`BenchSpec`   — optional registered-suite benchmark pass;
* :class:`ObsSpec`     — optional telemetry level (off / metrics / trace
  / profile, DESIGN.md §14);
* :class:`DryrunSpec`  — optional multi-pod dry run whose per-device
  census lands in the telemetry artifact format.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Any, Dict, Mapping, Optional, Tuple

_ALGS = ("dhlp1", "dhlp2")
_MODES = ("batched", "sequential")
_SEED_MODES = (None, "fixed", "drift")
_NETWORK_KINDS = ("scenario", "drugnet", "file")
_EVAL_PROTOCOLS = ("recovery", "cv")
_OBS_LEVELS = ("off", "metrics", "trace", "profile")
# mirrors repro_torch.serve.types.PRIORITY_CLASSES (this module stays
# import-light; the sync is asserted by tests/test_api_spec.py)
_PRIORITY_CLASSES = ("interactive", "refresh", "bulk")
_DRYRUN_MESHES = ("single", "multi", "both")
_STORAGE_DTYPES = ("f32", "bf16")
_RUN_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class SpecError(ValueError):
    """A spec failed validation (unknown key, bad value, conflict)."""


def _require_mapping(d: Any, path: str) -> Mapping[str, Any]:
    if not isinstance(d, Mapping):
        raise SpecError(f"{path}: expected a mapping, got {type(d).__name__}")
    return d


def _check_keys(cls, d: Mapping[str, Any], path: str) -> None:
    """Strict unknown-key rejection — a typo'd knob must not no-op."""
    allowed = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - allowed)
    if unknown:
        raise SpecError(
            f"{path}: unknown key(s) {unknown}; allowed: {sorted(allowed)}"
        )


def _as_pair(v: Any, path: str) -> Optional[Tuple[int, int]]:
    if v is None:
        return None
    if not isinstance(v, (list, tuple)) or len(v) != 2:
        raise SpecError(f"{path}: expected a [i, j] pair, got {v!r}")
    i, j = v
    if not (isinstance(i, int) and isinstance(j, int)) or i < 0 or j < 0:
        raise SpecError(f"{path}: pair entries must be ints >= 0, got {v!r}")
    return (i, j)


def _positive(value, name: str, *, strict: bool = True) -> None:
    bad = value <= 0 if strict else value < 0
    if bad:
        op = ">" if strict else ">="
        raise SpecError(f"{name} must be {op} 0, got {value}")


# --------------------------------------------------------------------------
# Sections
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """What graph the run operates on.

    ``kind="scenario"`` names a registered workload (``name`` required;
    ``scale``/``seed``/``params`` forwarded to the builder, ``cache``
    overrides the scenario disk cache).  ``kind="drugnet"`` builds the
    paper's case-study network (``params`` = ``DrugNetSpec`` overrides).
    ``kind="file"`` loads a saved network from ``path`` (no ground
    truth, so ``eval`` sections reject it).
    """

    kind: str = "scenario"
    name: Optional[str] = None
    scale: float = 1.0
    seed: int = 0
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    path: Optional[str] = None
    cache: Optional[bool] = None  # None = scenario-cache policy default

    def __post_init__(self) -> None:
        if self.kind not in _NETWORK_KINDS:
            raise SpecError(
                f"network.kind must be one of {_NETWORK_KINDS}, "
                f"got {self.kind!r}"
            )
        _positive(self.scale, "network.scale")
        if not isinstance(self.params, dict):
            raise SpecError("network.params must be a mapping")
        if self.kind == "scenario":
            if not self.name:
                raise SpecError("network.kind='scenario' requires a name")
            if self.path is not None:
                raise SpecError(
                    "network.path conflicts with kind='scenario' (path is "
                    "for kind='file')"
                )
        else:
            if self.name is not None:
                raise SpecError(
                    f"network.name={self.name!r} conflicts with "
                    f"kind={self.kind!r} (name selects a scenario)"
                )
            if self.cache is not None:
                raise SpecError("network.cache applies only to kind='scenario'")
            if self.scale != 1.0:
                raise SpecError(
                    "network.scale applies only to kind='scenario' "
                    "(size drugnet via params, files are fixed)"
                )
        if self.kind == "file":
            if not self.path:
                raise SpecError("network.kind='file' requires a path")
            if self.params:
                raise SpecError(
                    "network.params conflicts with kind='file' (the file "
                    "is self-contained)"
                )
        elif self.kind == "drugnet" and self.path is not None:
            raise SpecError("network.path is for kind='file'")

    @classmethod
    def from_dict(cls, d: Any, path: str = "network") -> "NetworkSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """How to propagate, and which ranking the solve artifact reports."""

    alg: str = "dhlp2"
    alpha: float = 0.5
    sigma: float = 1e-3
    mode: str = "batched"
    seed_mode: Optional[str] = None  # None = per-pseudocode default
    backend: Optional[str] = None  # engine-registry key; None = auto policy
    devices: Optional[int] = None  # sharded only
    momentum: float = 0.0
    max_iter: int = 1000
    # mixed precision (sparse/kernel backends): "bf16" stores operator
    # weights + the gather panel in bfloat16 (fp32 state/accumulation)
    storage_dtype: str = "f32"
    # consult the persisted blocked-CSR autotune cache (False pins the
    # layout/panel defaults unconditionally)
    autotune: bool = True
    # the ranking reported by the solve artifact (paper step G)
    top_k: int = 20
    entity: int = 0
    rank_pair: Optional[Tuple[int, int]] = None  # None = the eval pair

    def __post_init__(self) -> None:
        if self.alg not in _ALGS:
            raise SpecError(f"solve.alg must be one of {_ALGS}, got {self.alg!r}")
        if self.storage_dtype not in _STORAGE_DTYPES:
            raise SpecError(
                f"solve.storage_dtype must be one of {_STORAGE_DTYPES}, "
                f"got {self.storage_dtype!r}"
            )
        if not isinstance(self.autotune, bool):
            raise SpecError(
                f"solve.autotune must be true/false, got {self.autotune!r}"
            )
        if self.mode not in _MODES:
            raise SpecError(f"solve.mode must be one of {_MODES}, got {self.mode!r}")
        if self.seed_mode not in _SEED_MODES:
            raise SpecError(
                f"solve.seed_mode must be one of {_SEED_MODES}, "
                f"got {self.seed_mode!r}"
            )
        if not 0.0 < self.alpha < 1.0:
            raise SpecError(f"solve.alpha must be in (0, 1), got {self.alpha}")
        _positive(self.sigma, "solve.sigma")
        _positive(self.max_iter, "solve.max_iter")
        _positive(self.top_k, "solve.top_k")
        _positive(self.momentum, "solve.momentum", strict=False)
        _positive(self.entity, "solve.entity", strict=False)
        if self.devices is not None:
            _positive(self.devices, "solve.devices")
            if self.backend != "sharded":
                raise SpecError(
                    f"solve.devices={self.devices} requires "
                    f"backend='sharded' (got {self.backend!r})"
                )
        object.__setattr__(
            self, "rank_pair", _as_pair(self.rank_pair, "solve.rank_pair")
        )

    @classmethod
    def from_dict(cls, d: Any, path: str = "solve") -> "SolveSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))

    def to_lp_config(self, *, seed_mode: Optional[str] = None, backend=None):
        """The equivalent :class:`~repro_torch.core.solver.LPConfig` (lazy
        import — this module stays runtime-free)."""
        from repro_torch.core.solver import LPConfig

        return LPConfig(
            alg=self.alg,
            alpha=self.alpha,
            sigma=self.sigma,
            mode=self.mode,
            seed_mode=seed_mode or self.seed_mode,
            momentum=self.momentum,
            max_iter=self.max_iter,
            backend=backend if backend is not None else self.backend,
            storage_dtype=self.storage_dtype,
            autotune=self.autotune,
        )


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """Scoring protocol against the network's planted ground truth."""

    protocol: str = "recovery"
    folds: int = 5  # cv
    holdout_frac: float = 0.1  # recovery
    max_entities: int = 32  # recovery
    seed: int = 0
    pair: Optional[Tuple[int, int]] = None  # None = the bundle's eval pair

    def __post_init__(self) -> None:
        if self.protocol not in _EVAL_PROTOCOLS:
            raise SpecError(
                f"eval.protocol must be one of {_EVAL_PROTOCOLS}, "
                f"got {self.protocol!r}"
            )
        if self.folds < 2:
            raise SpecError(f"eval.folds must be >= 2, got {self.folds}")
        if not 0.0 < self.holdout_frac < 1.0:
            raise SpecError(
                f"eval.holdout_frac must be in (0, 1), got {self.holdout_frac}"
            )
        _positive(self.max_entities, "eval.max_entities")
        object.__setattr__(self, "pair", _as_pair(self.pair, "eval.pair"))

    @classmethod
    def from_dict(cls, d: Any, path: str = "eval") -> "EvalSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Online workload played against the serve stack.

    ``trace`` names an arrival process (poisson | bursty | diurnal) for
    scenario trace replay; ``None`` plays the synthetic zipf workload
    the legacy serve CLI used.  ``engine`` is redundant with
    ``solve.backend`` — setting both to different keys is a conflict
    (the session runs ONE engine across solve → eval → serve).

    The pipelined-tier knobs default to production settings
    (``pipeline_depth=2``, ``cache_shards=4``); library users
    constructing a bare :class:`repro_torch.serve.ServeConfig` get the
    conservative synchronous defaults instead.  ``early_exit=None``
    auto-enables per-column convergence early exit whenever the solve
    section permits it (dhlp2, no momentum).
    """

    engine: Optional[str] = None
    trace: Optional[str] = None
    # synthetic-workload knobs (trace=None); source/target default to the
    # bundle's eval pair — setting them points the zipf workload at any
    # other (source, target) type pair
    requests: int = 200
    zipf: float = 1.3
    deltas: int = 0
    source_type: Optional[int] = None
    target_type: Optional[int] = None
    # trace-replay knobs
    rate_qps: float = 40.0
    horizon_s: float = 3.0
    time_scale: float = 1.0
    apply_deltas: bool = True
    # engine knobs
    top_k: int = 20
    cache_columns: int = 4096
    warm_start: bool = True
    refresh_rounds: int = 0
    max_batch: int = 64
    max_wait_ms: float = 2.0
    queue_depth: int = 1024
    # pipelined-tier knobs (DESIGN.md §9.1)
    pipeline_depth: int = 2       # 1 = synchronous tick, 2 = double-buffered
    cache_shards: int = 4         # independently-locked column-cache shards
    early_exit: Optional[bool] = None  # None = auto (dhlp2 w/o momentum)
    priority: str = "interactive"      # admission class for replayed queries

    def __post_init__(self) -> None:
        if self.trace is not None and (
            not isinstance(self.trace, str) or not self.trace
        ):
            raise SpecError(
                f"serve.trace must be an arrival-process name, "
                f"got {self.trace!r}"
            )
        _positive(self.requests, "serve.requests")
        if self.zipf <= 1.0:
            raise SpecError(f"serve.zipf must be > 1, got {self.zipf}")
        _positive(self.deltas, "serve.deltas", strict=False)
        for knob, value in (
            ("source_type", self.source_type),
            ("target_type", self.target_type),
        ):
            if value is not None:
                if not isinstance(value, int) or isinstance(value, bool):
                    raise SpecError(
                        f"serve.{knob} must be a node-type index, got {value!r}"
                    )
                _positive(value, f"serve.{knob}", strict=False)
                if self.trace is not None:
                    raise SpecError(
                        f"serve.{knob} applies to the zipf workload only "
                        "(trace replays carry their own query targets)"
                    )
        _positive(self.rate_qps, "serve.rate_qps")
        _positive(self.horizon_s, "serve.horizon_s")
        _positive(self.time_scale, "serve.time_scale")
        _positive(self.top_k, "serve.top_k")
        _positive(self.cache_columns, "serve.cache_columns")
        _positive(self.refresh_rounds, "serve.refresh_rounds", strict=False)
        _positive(self.max_batch, "serve.max_batch")
        _positive(self.max_wait_ms, "serve.max_wait_ms", strict=False)
        _positive(self.queue_depth, "serve.queue_depth")
        _positive(self.pipeline_depth, "serve.pipeline_depth")
        _positive(self.cache_shards, "serve.cache_shards")
        if self.cache_shards > self.cache_columns:
            raise SpecError(
                f"serve.cache_shards={self.cache_shards} > "
                f"serve.cache_columns={self.cache_columns}: every shard "
                "needs at least one slot"
            )
        if self.early_exit is not None and not isinstance(
            self.early_exit, bool
        ):
            raise SpecError(
                f"serve.early_exit must be true/false/null, "
                f"got {self.early_exit!r}"
            )
        if self.priority not in _PRIORITY_CLASSES:
            raise SpecError(
                f"serve.priority must be one of {_PRIORITY_CLASSES}, "
                f"got {self.priority!r}"
            )

    @classmethod
    def from_dict(cls, d: Any, path: str = "serve") -> "ServeSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))

    def resolved_early_exit(self, solve: "SolveSpec") -> bool:
        """Whether batch solves run the per-column early-exit loop.

        ``None`` auto-enables exactly when the solve section permits it:
        dhlp2 (the loop rides the fused-round contract) without momentum
        (the loop is the plain heavy-ball-free update).
        """
        if self.early_exit is not None:
            return self.early_exit
        return solve.alg == "dhlp2" and not solve.momentum


@dataclasses.dataclass(frozen=True)
class BenchSpec:
    """A registered-suite benchmark pass through ``repro_torch.bench``."""

    suites: Optional[Tuple[str, ...]] = None  # None = every registered suite
    fast: bool = True
    label: Optional[str] = None  # None = "ci" (fast) / "full"

    def __post_init__(self) -> None:
        if self.suites is not None:
            if not isinstance(self.suites, (list, tuple)) or not all(
                isinstance(s, str) and s for s in self.suites
            ):
                raise SpecError(
                    f"bench.suites must be suite names, got {self.suites!r}"
                )
            object.__setattr__(self, "suites", tuple(self.suites))

    @classmethod
    def from_dict(cls, d: Any, path: str = "bench") -> "BenchSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))

    def resolved_label(self) -> str:
        return self.label or ("ci" if self.fast else "full")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Service-level objectives the live watchdog evaluates per flush
    window (DESIGN.md §14.9).

    Each objective is optional but at least one must be set.
    ``latency_p95_ms`` bounds the windowed p95 of interactive serve
    latency; ``error_rate`` caps (failed + rejected) / completed-or-
    errored traffic; ``cache_hit_floor`` is the minimum column-cache hit
    ratio under lookup traffic; ``stall_windows`` flags a convergence
    stall when the solve residual stops improving for that many
    consecutive windows.  ``burn_windows`` consecutive violating windows
    raise a breach (and escalate serve degradation one rung);
    ``recovery_windows`` consecutive clean windows restore.
    """

    latency_p95_ms: Optional[float] = None
    error_rate: Optional[float] = None
    cache_hit_floor: Optional[float] = None
    stall_windows: Optional[int] = None
    burn_windows: int = 3
    recovery_windows: int = 2

    def __post_init__(self) -> None:
        objectives = (
            self.latency_p95_ms,
            self.error_rate,
            self.cache_hit_floor,
            self.stall_windows,
        )
        if all(v is None for v in objectives):
            raise SpecError(
                "obs.slo: at least one objective required "
                "(latency_p95_ms / error_rate / cache_hit_floor / stall_windows)"
            )
        if self.latency_p95_ms is not None:
            _positive(self.latency_p95_ms, "obs.slo.latency_p95_ms")
        for name in ("error_rate", "cache_hit_floor"):
            value = getattr(self, name)
            if value is not None and not 0.0 <= value <= 1.0:
                raise SpecError(
                    f"obs.slo.{name} must be in [0, 1], got {value}"
                )
        if self.stall_windows is not None:
            _positive(self.stall_windows, "obs.slo.stall_windows")
        _positive(self.burn_windows, "obs.slo.burn_windows")
        _positive(self.recovery_windows, "obs.slo.recovery_windows")

    @classmethod
    def from_dict(cls, d: Any, path: str = "obs.slo") -> "SLOSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Telemetry level + live-streaming knobs for the run (DESIGN.md §14).

    ``metrics`` records counters/gauges/histograms + structural spans;
    ``trace`` adds per-superstep and per-query spans; ``profile`` adds
    the profiler capture and kernel timing hooks.  Writing the
    section at all defaults to ``metrics`` — an explicit ``off`` keeps
    the spec round-trippable while disabling collection.

    ``flush_interval_s`` turns on live streaming: telemetry flushes
    incrementally at that cadence while the run executes, so
    ``repro obs --follow`` can tail it.  ``export`` controls the
    OpenMetrics ``metrics.prom`` snapshot written on each flush (and the
    final one).  ``slo`` declares watchdog objectives — it requires
    streaming (``flush_interval_s``) because evaluation is per flush
    window, and a level that actually collects.
    """

    level: str = "metrics"
    flush_interval_s: Optional[float] = None
    export: bool = True
    slo: Optional[SLOSpec] = None

    def __post_init__(self) -> None:
        if self.level not in _OBS_LEVELS:
            raise SpecError(
                f"obs.level must be one of {_OBS_LEVELS}, got {self.level!r}"
            )
        if self.flush_interval_s is not None:
            _positive(self.flush_interval_s, "obs.flush_interval_s")
        if self.slo is not None:
            if self.flush_interval_s is None:
                raise SpecError(
                    "obs.slo requires obs.flush_interval_s: the watchdog "
                    "evaluates per streaming flush window"
                )
            if self.level == "off":
                raise SpecError("obs.slo requires obs.level != 'off'")

    @classmethod
    def from_dict(cls, d: Any, path: str = "obs") -> "ObsSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        d = dict(d)
        if d.get("slo") is not None:
            d["slo"] = SLOSpec.from_dict(d["slo"], f"{path}.slo")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FTSpec:
    """Fault-tolerance & durability knobs for the run (DESIGN.md §16).

    Writing the section turns durability on: the solve stage checkpoints
    label state + its outer-iteration cursor every ``interval``
    supersteps through :class:`repro_torch.checkpoint.CheckpointManager` (so a
    killed run resumes via ``repro run --resume <run_id>`` with
    byte-identical final rankings), and the serve tier wraps solver-batch
    execution in :class:`repro_torch.ft.StepGuard` — transient faults retry
    with backoff, exhaustion restores from the last cache snapshot and
    replays the in-flight batch.

    ``ckpt_dir=None`` defaults to ``checkpoints/`` inside the run's
    artifact directory.  ``interval`` counts supersteps for the solve and
    solver batches for the serve tier.  The ``inject_*`` knobs arm the
    deterministic :class:`repro_torch.ft.FailureInjector` for recovery drills:
    ``inject_solve_fault`` kills the solve at those supersteps (a fresh
    run only — a resumed run never re-fires, a real crash is not
    deterministic either), ``inject_serve_fault`` raises a transient
    fault in the solver thread at those batch indices.
    """

    ckpt_dir: Optional[str] = None
    interval: int = 5
    keep_last: int = 3
    async_write: bool = False
    max_retries: int = 3
    backoff_s: float = 0.05
    straggler_alpha: float = 0.1
    straggler_threshold: float = 2.0
    inject_solve_fault: Tuple[int, ...] = ()
    inject_serve_fault: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.ckpt_dir is not None and (
            not isinstance(self.ckpt_dir, str) or not self.ckpt_dir
        ):
            raise SpecError(f"ft.ckpt_dir must be a path, got {self.ckpt_dir!r}")
        if not isinstance(self.interval, int) or isinstance(self.interval, bool):
            raise SpecError(f"ft.interval must be an int, got {self.interval!r}")
        _positive(self.interval, "ft.interval")
        _positive(self.keep_last, "ft.keep_last")
        if self.max_retries < 0:
            raise SpecError(f"ft.max_retries must be >= 0, got {self.max_retries}")
        _positive(self.backoff_s, "ft.backoff_s", strict=False)
        if not 0.0 < self.straggler_alpha <= 1.0:
            raise SpecError(
                f"ft.straggler_alpha must be in (0, 1], got {self.straggler_alpha}"
            )
        if self.straggler_threshold <= 1.0:
            raise SpecError(
                "ft.straggler_threshold must be > 1 (a straggler is slower "
                f"than the mean), got {self.straggler_threshold}"
            )
        for knob in ("inject_solve_fault", "inject_serve_fault"):
            value = getattr(self, knob)
            if not isinstance(value, (list, tuple)) or not all(
                isinstance(s, int) and not isinstance(s, bool) and s >= 0
                for s in value
            ):
                raise SpecError(
                    f"ft.{knob} must be step indices, got {value!r}"
                )
            object.__setattr__(self, knob, tuple(value))

    @classmethod
    def from_dict(cls, d: Any, path: str = "ft") -> "FTSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """A model-training run (lm / gnn / recsys arch families).

    Folds the ``launch/train`` driver behind the declarative API: the
    arch registry resolves ``arch`` to a family, the session runs the
    guarded training loop (periodic checkpoints, retry/restore on
    transient failures, straggler watch, optional injected faults).
    LP-family archs are rejected at session resolution — label
    propagation runs via a ``solve`` section.
    """

    arch: str = ""
    steps: int = 50
    batch: int = 8
    seq: int = 128
    full: bool = False  # full pod-scale config (default: reduced)
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    ckpt_async: bool = False
    inject_fault: Tuple[int, ...] = ()  # steps that raise a transient fault
    log_every: int = 10

    def __post_init__(self) -> None:
        if not self.arch or not isinstance(self.arch, str):
            raise SpecError("train.arch is required (a registered arch name)")
        _positive(self.steps, "train.steps")
        _positive(self.batch, "train.batch")
        _positive(self.seq, "train.seq")
        _positive(self.ckpt_every, "train.ckpt_every")
        _positive(self.log_every, "train.log_every")
        if not isinstance(self.inject_fault, (list, tuple)) or not all(
            isinstance(s, int) and not isinstance(s, bool) and s >= 0
            for s in self.inject_fault
        ):
            raise SpecError(
                f"train.inject_fault must be step indices, "
                f"got {self.inject_fault!r}"
            )
        object.__setattr__(self, "inject_fault", tuple(self.inject_fault))
        if self.ckpt_async and self.ckpt_dir is None:
            raise SpecError("train.ckpt_async requires train.ckpt_dir")

    @classmethod
    def from_dict(cls, d: Any, path: str = "train") -> "TrainSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))


@dataclasses.dataclass(frozen=True)
class DryrunSpec:
    """A multi-pod dry run: every config cell's per-device census on the
    production meshes (:mod:`repro_torch.launch.dryrun`).

    ``archs=None`` sweeps every assigned (arch × shape) cell; naming
    ``archs`` restricts the sweep (``shapes`` then applies to each named
    arch).  The census is emitted through the telemetry artifact format
    (``telemetry/dryrun.jsonl``) that the ``roofline`` suite consumes.
    """

    archs: Optional[Tuple[str, ...]] = None
    shapes: Optional[Tuple[str, ...]] = None
    mesh: str = "single"
    include_extra: bool = False

    def __post_init__(self) -> None:
        if self.mesh not in _DRYRUN_MESHES:
            raise SpecError(
                f"dryrun.mesh must be one of {_DRYRUN_MESHES}, got {self.mesh!r}"
            )
        for knob, value in (("archs", self.archs), ("shapes", self.shapes)):
            if value is not None:
                if not isinstance(value, (list, tuple)) or not all(
                    isinstance(s, str) and s for s in value
                ):
                    raise SpecError(f"dryrun.{knob} must be names, got {value!r}")
                object.__setattr__(self, knob, tuple(value))
        if self.shapes is not None and self.archs is None:
            raise SpecError("dryrun.shapes requires dryrun.archs")

    @classmethod
    def from_dict(cls, d: Any, path: str = "dryrun") -> "DryrunSpec":
        d = _require_mapping(d, path)
        _check_keys(cls, d, path)
        return cls(**dict(d))


# --------------------------------------------------------------------------
# The composed run
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One declarative job: network × solve × (eval? serve? bench? …)."""

    #: None is allowed ONLY for a train- and/or dryrun-only spec — those
    #: stages exercise model configs, not a propagation network
    network: Optional[NetworkSpec] = None
    #: None = default solve parameters; the solve STAGE runs when this
    #: section is explicitly present, or when no other stage is configured
    solve: Optional[SolveSpec] = None
    eval: Optional[EvalSpec] = None
    serve: Optional[ServeSpec] = None
    bench: Optional[BenchSpec] = None
    obs: Optional[ObsSpec] = None
    ft: Optional[FTSpec] = None
    train: Optional[TrainSpec] = None
    dryrun: Optional[DryrunSpec] = None
    run_id: Optional[str] = None  # None = deterministic content-derived id

    def __post_init__(self) -> None:
        if self.run_id is not None and not _RUN_ID_RE.match(self.run_id):
            raise SpecError(
                f"run_id {self.run_id!r} is not filesystem-safe "
                "([A-Za-z0-9._-], no leading punctuation)"
            )
        sections = self.sections()
        if self.network is None and not (
            sections and all(s in ("train", "dryrun") for s in sections)
        ):
            raise SpecError(
                "runspec: a 'network' section is required (only a "
                "train- and/or dryrun-only spec runs without one)"
            )
        solve = self.resolved_solve()
        if self.serve is not None:
            if (
                self.serve.engine is not None
                and solve.backend is not None
                and self.serve.engine != solve.backend
            ):
                raise SpecError(
                    f"serve.engine={self.serve.engine!r} conflicts with "
                    f"solve.backend={solve.backend!r}; the session "
                    "runs one engine — set one key (or both to the same)"
                )
            if solve.seed_mode == "drift":
                raise SpecError(
                    "serve requires solve.seed_mode='fixed' (warm starts "
                    "need the F0-independent fixed point, DESIGN.md §9)"
                )
            if self.serve.early_exit:
                if solve.alg != "dhlp2":
                    raise SpecError(
                        "serve.early_exit=true requires solve.alg='dhlp2' "
                        "(the per-column loop rides the fused DHLP-2 "
                        "round contract)"
                    )
                if solve.momentum:
                    raise SpecError(
                        "serve.early_exit=true conflicts with "
                        "solve.momentum — the early-exit loop is the "
                        "plain heavy-ball-free update (set early_exit "
                        "to false or null)"
                    )
        if self.eval is not None and self.network.kind == "file":
            raise SpecError(
                "eval sections need planted ground truth; "
                "network.kind='file' carries none"
            )
        if self.ft is not None:
            stages = set(self.sections())
            if not ({"solve", "serve"} & stages):
                raise SpecError(
                    "ft: nothing to protect — the section governs the "
                    "solve and serve stages"
                )
            if "solve" in stages:
                if solve.alg != "dhlp2" or solve.mode != "batched":
                    raise SpecError(
                        "ft superstep checkpointing rides the host-driven "
                        "batched DHLP-2 round contract; set "
                        "solve.alg='dhlp2' and solve.mode='batched'"
                    )
                seed_mode = solve.seed_mode or (
                    "fixed" if self.serve is not None else "drift"
                )
                if seed_mode != "fixed":
                    raise SpecError(
                        "ft requires solve.seed_mode='fixed' — a resumed "
                        "run replays from a checkpointed label panel, "
                        "which drifting seeds would invalidate"
                    )

    # ----------------------------------------------------------- round-trip
    @classmethod
    def from_dict(cls, d: Any) -> "RunSpec":
        d = _require_mapping(d, "runspec")
        _check_keys(cls, d, "runspec")
        networkless_ok = (
            d.get("dryrun") is not None or d.get("train") is not None
        ) and not any(
            d.get(k) is not None for k in ("solve", "eval", "serve", "bench")
        )
        if "network" not in d and not networkless_ok:
            raise SpecError("runspec: a 'network' section is required")
        return cls(
            network=(
                NetworkSpec.from_dict(d["network"])
                if d.get("network") is not None
                else None
            ),
            solve=(
                SolveSpec.from_dict(d["solve"])
                if d.get("solve") is not None
                else None
            ),
            eval=(EvalSpec.from_dict(d["eval"]) if d.get("eval") is not None else None),
            serve=(
                ServeSpec.from_dict(d["serve"])
                if d.get("serve") is not None
                else None
            ),
            bench=(
                BenchSpec.from_dict(d["bench"])
                if d.get("bench") is not None
                else None
            ),
            obs=(ObsSpec.from_dict(d["obs"]) if d.get("obs") is not None else None),
            ft=(FTSpec.from_dict(d["ft"]) if d.get("ft") is not None else None),
            train=(
                TrainSpec.from_dict(d["train"])
                if d.get("train") is not None
                else None
            ),
            dryrun=(
                DryrunSpec.from_dict(d["dryrun"])
                if d.get("dryrun") is not None
                else None
            ),
            run_id=d.get("run_id"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, s: str) -> "RunSpec":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise SpecError(f"runspec: invalid JSON ({e})") from e
        return cls.from_dict(d)

    def to_json(self, *, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_file(cls, path: str) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------------ identity
    def content_hash(self) -> str:
        """Stable digest of the spec content (run_id excluded)."""
        d = self.to_dict()
        d.pop("run_id", None)
        blob = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:10]

    def resolved_solve(self) -> SolveSpec:
        """The solve parameters eval/serve stages run under (defaults
        when no ``solve`` section was written)."""
        return self.solve if self.solve is not None else SolveSpec()

    def resolved_run_id(self) -> str:
        """Explicit ``run_id``, else a deterministic content-derived slug
        — the same spec always lands in the same ``results/<run_id>/``."""
        if self.run_id:
            return self.run_id
        if self.network is None:
            prefix = "train" if self.dryrun is None else "dryrun"
            return f"{prefix}-{self.content_hash()}"
        solve = self.resolved_solve()
        net = self.network.name or self.network.kind
        backend = solve.backend or "auto"
        return f"{net}-{solve.alg}-{backend}-{self.content_hash()}"

    def sections(self) -> Tuple[str, ...]:
        """The configured run stages, in execution order.

        ``solve`` runs when its section is explicitly present — or when
        nothing else is, so a bare ``{"network": ...}`` spec is a solve.
        (``obs`` is cross-cutting, not a stage; ``train`` and ``dryrun``
        never imply a solve.)
        """
        out = []
        others = [self.eval, self.serve, self.bench, self.train, self.dryrun]
        if self.solve is not None or not any(s is not None for s in others):
            out.append("solve")
        if self.eval is not None:
            out.append("eval")
        if self.serve is not None:
            out.append("serve")
        if self.bench is not None:
            out.append("bench")
        if self.train is not None:
            out.append("train")
        if self.dryrun is not None:
            out.append("dryrun")
        return tuple(out)
