"""Versioned record/report schema for ``BENCH_*.json``.

One record per (suite, case, backend) with a stable key so trajectories
can be compared across PRs.  ``strict`` names the derived metrics that are
correctness-derived (iteration counts, accuracy, agreement-vs-dense) and
therefore hard-gate in ``repro_torch.bench.compare`` regardless of how noisy the
runner's wall clock is (DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

SCHEMA_VERSION = 1

_STATS_FIELDS = (
    "repeats",
    "warmup",
    "median_s",
    "p10_s",
    "p90_s",
    "mean_s",
    "min_s",
    "max_s",
)

_ENV_FIELDS = ("platform", "machine", "backend", "device_kind", "device_count")


class SchemaError(ValueError):
    """A BENCH record/report does not conform to the schema."""


@dataclasses.dataclass
class BenchRecord:
    """One benchmark measurement.

    ``derived`` holds metric-name → float (throughput AND correctness
    metrics); ``strict`` lists the subset of derived keys that must match
    the baseline within the strict tolerance.  ``telemetry`` optionally
    embeds an obs summary digest (DESIGN.md §14.5) — purely informational
    and never compared by ``repro_torch.bench.compare``.
    """

    suite: str
    name: str
    backend: str
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    derived: Dict[str, float] = dataclasses.field(default_factory=dict)
    strict: List[str] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    telemetry: Optional[Dict[str, object]] = None

    def to_dict(self) -> Dict[str, object]:
        d = dataclasses.asdict(self)
        if self.error is None:
            d.pop("error")
        if self.telemetry is None:
            d.pop("telemetry")
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, object]) -> "BenchRecord":
        validate_record(d)
        return cls(
            suite=str(d["suite"]),
            name=str(d["name"]),
            backend=str(d["backend"]),
            params=dict(d.get("params", {})),
            stats=dict(d.get("stats", {})),
            derived=dict(d.get("derived", {})),
            strict=list(d.get("strict", [])),
            error=d.get("error"),
            telemetry=(
                dict(d["telemetry"]) if d.get("telemetry") is not None else None
            ),
        )


def record_key(record: Mapping[str, object]) -> str:
    """Stable identity of a measurement across runs: suite/name@backend."""
    if isinstance(record, BenchRecord):
        record = record.to_dict()
    return f"{record['suite']}/{record['name']}@{record['backend']}"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise SchemaError(msg)


def validate_record(d: Mapping[str, object]) -> None:
    """Raise :class:`SchemaError` unless ``d`` is a valid record dict."""
    if isinstance(d, BenchRecord):
        d = d.to_dict()
    _require(isinstance(d, Mapping), f"record must be a mapping, got {type(d)}")
    for field in ("suite", "name", "backend"):
        _require(
            isinstance(d.get(field), str) and d[field] != "",
            f"record.{field} must be a non-empty string",
        )
    _require(
        isinstance(d.get("params", {}), Mapping),
        "record.params must be a mapping",
    )
    stats = d.get("stats", {})
    _require(isinstance(stats, Mapping), "record.stats must be a mapping")
    if stats:
        for f in _STATS_FIELDS:
            _require(
                isinstance(stats.get(f), (int, float)),
                f"record.stats.{f} must be a number",
            )
        _require(stats["repeats"] >= 1, "record.stats.repeats must be >= 1")
        _require(
            stats["min_s"] <= stats["median_s"] <= stats["max_s"],
            "record.stats median must lie within [min, max]",
        )
    derived = d.get("derived", {})
    _require(isinstance(derived, Mapping), "record.derived must be a mapping")
    for k, v in derived.items():
        _require(isinstance(k, str), "record.derived keys must be strings")
        _require(
            isinstance(v, (int, float, bool)),
            f"record.derived[{k!r}] must be numeric",
        )
    strict = d.get("strict", [])
    _require(
        isinstance(strict, Sequence) and not isinstance(strict, (str, bytes)),
        "record.strict must be a list",
    )
    for k in strict:
        _require(
            k in derived,
            f"record.strict key {k!r} has no matching derived metric",
        )
    err = d.get("error")
    _require(err is None or isinstance(err, str), "record.error must be a string")
    tel = d.get("telemetry")
    _require(
        tel is None or isinstance(tel, Mapping),
        "record.telemetry must be a mapping when present",
    )
    _require(
        bool(stats) or err is not None,
        "record must carry stats unless it is an error record",
    )


def validate_report(d: Mapping[str, object]) -> None:
    """Raise :class:`SchemaError` unless ``d`` is a valid report dict."""
    _require(isinstance(d, Mapping), "report must be a mapping")
    _require(
        d.get("schema_version") == SCHEMA_VERSION,
        f"report.schema_version must be {SCHEMA_VERSION}, "
        f"got {d.get('schema_version')!r}",
    )
    _require(
        isinstance(d.get("label"), str) and d["label"] != "",
        "report.label must be a non-empty string",
    )
    _require(
        isinstance(d.get("created_unix"), (int, float)),
        "report.created_unix must be a number",
    )
    env = d.get("environment")
    _require(isinstance(env, Mapping), "report.environment must be a mapping")
    for f in _ENV_FIELDS:
        _require(f in env, f"report.environment.{f} missing")
    records = d.get("records")
    _require(isinstance(records, list), "report.records must be a list")
    seen = set()
    for rec in records:
        validate_record(rec)
        key = record_key(rec)
        _require(key not in seen, f"duplicate record key {key!r}")
        seen.add(key)
