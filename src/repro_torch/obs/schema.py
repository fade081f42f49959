"""Telemetry JSONL schema validation (DESIGN.md §14.1).

Every telemetry file leads with a ``meta`` line naming the schema
version; subsequent lines are ``span`` / ``event`` / ``metric`` records.
:func:`validate_dir` is what CI runs against the quickstart run's
``results/<run_id>/telemetry/`` output, and what ``repro_torch obs --validate``
exposes.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

from repro_torch.obs.telemetry import LEVELS, SCHEMA

_METRIC_TYPES = ("counter", "gauge", "histogram")


class TelemetryError(ValueError):
    """A telemetry line/file does not conform to the schema."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise TelemetryError(msg)


def _require_id(d: Mapping[str, Any], key: str, *, nullable: bool = False) -> None:
    v = d.get(key)
    if nullable and v is None:
        return
    _require(
        isinstance(v, int) and not isinstance(v, bool) and v >= 0,
        f"{d.get('kind')}.{key} must be an int >= 0, got {v!r}",
    )


def _require_num(d: Mapping[str, Any], key: str) -> None:
    v = d.get(key)
    _require(
        isinstance(v, (int, float)) and not isinstance(v, bool),
        f"{d.get('kind')}.{key} must be a number, got {v!r}",
    )


def validate_line(d: Any) -> str:
    """Validate one telemetry record; returns its ``kind``."""
    _require(isinstance(d, Mapping), f"line must be a mapping, got {type(d)}")
    kind = d.get("kind")
    if kind == "meta":
        _require(
            d.get("schema") == SCHEMA,
            f"meta.schema must be {SCHEMA!r}, got {d.get('schema')!r}",
        )
        level = d.get("level")
        _require(
            level is None or level in LEVELS,
            f"meta.level must be one of {LEVELS}, got {level!r}",
        )
    elif kind == "span":
        _require_id(d, "id")
        _require_id(d, "parent", nullable=True)
        for key in ("span", "name"):
            _require(
                isinstance(d.get(key), str) and d[key] != "",
                f"span.{key} must be a non-empty string",
            )
        _require_num(d, "t0")
        _require_num(d, "dur_s")
        _require(d["dur_s"] >= 0, f"span.dur_s must be >= 0, got {d['dur_s']}")
    elif kind == "event":
        _require_id(d, "id")
        _require_id(d, "parent", nullable=True)
        _require(
            isinstance(d.get("name"), str) and d["name"] != "",
            "event.name must be a non-empty string",
        )
        _require_num(d, "t")
        attrs = d.get("attrs")
        _require(
            attrs is None or isinstance(attrs, Mapping),
            "event.attrs must be a mapping",
        )
    elif kind == "metric":
        _require(
            d.get("type") in _METRIC_TYPES,
            f"metric.type must be one of {_METRIC_TYPES}, got {d.get('type')!r}",
        )
        _require(
            isinstance(d.get("name"), str) and d["name"] != "",
            "metric.name must be a non-empty string",
        )
        if d["type"] == "counter":
            _require_num(d, "value")
        elif d["type"] == "gauge":
            series = d.get("series")
            _require(isinstance(series, list), "gauge.series must be a list")
            for point in series:
                _require(
                    isinstance(point, list) and len(point) == 2,
                    f"gauge.series points must be [t, value], got {point!r}",
                )
        else:  # histogram
            for key in ("count", "sum"):
                _require_num(d, key)
            edges, counts = d.get("edges"), d.get("counts")
            _require(isinstance(edges, list), "histogram.edges must be a list")
            _require(isinstance(counts, list), "histogram.counts must be a list")
            _require(
                len(counts) == len(edges) + 1,
                f"histogram must carry len(edges)+1 counts, got "
                f"{len(counts)} for {len(edges)} edges",
            )
            _require(
                sum(counts) == d["count"],
                "histogram bucket counts must sum to count",
            )
    else:
        raise TelemetryError(f"unknown record kind {kind!r}")
    return str(kind)


def validate_file(path: str) -> Dict[str, int]:
    """Validate one telemetry JSONL file; returns per-kind line counts."""
    counts: Dict[str, int] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                raise TelemetryError(f"{path}:{i + 1}: invalid JSON ({e})") from e
            try:
                kind = validate_line(d)
            except TelemetryError as e:
                raise TelemetryError(f"{path}:{i + 1}: {e}") from e
            _require(
                i > 0 or kind == "meta",
                f"{path}: first line must be a meta record, got {kind!r}",
            )
            counts[kind] = counts.get(kind, 0) + 1
    _require(counts.get("meta", 0) >= 1, f"{path}: no meta line")
    return counts


def validate_dir(path: str) -> Dict[str, int]:
    """Validate a ``results/<run_id>/telemetry/`` directory.

    ``events.jsonl`` and ``metrics.jsonl`` are required (segment files
    ``events-NNNN.jsonl`` from a live stream are validated like any other
    JSONL — each leads with its own meta line); ``summary.json`` must be
    a JSON object when present; a ``metrics.prom`` OpenMetrics snapshot
    is parsed and name-linted (the CI telemetry-artifact gate).  Returns
    merged per-kind counts.
    """
    _require(os.path.isdir(path), f"{path} is not a directory")
    for required in ("events.jsonl", "metrics.jsonl"):
        _require(
            os.path.isfile(os.path.join(path, required)),
            f"{path}: missing {required}",
        )
    counts: Dict[str, int] = {}
    for name in sorted(os.listdir(path)):
        if not name.endswith(".jsonl"):
            continue
        for kind, n in validate_file(os.path.join(path, name)).items():
            counts[kind] = counts.get(kind, 0) + n
    summary = os.path.join(path, "summary.json")
    if os.path.isfile(summary):
        with open(summary) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise TelemetryError(f"{summary}: invalid JSON ({e})") from e
        _require(isinstance(doc, dict), f"{summary}: must be a JSON object")
        counts["summary"] = 1
    prom = os.path.join(path, "metrics.prom")
    if os.path.isfile(prom):
        from repro_torch.obs.export import lint_openmetrics, parse_openmetrics

        with open(prom) as f:
            text = f.read()
        problems = lint_openmetrics(text)
        _require(
            not problems,
            f"{prom}: OpenMetrics lint failed: {'; '.join(problems)}",
        )
        counts["openmetrics"] = len(parse_openmetrics(text))
    return counts
