"""OpenMetrics / Prometheus text exposition (DESIGN.md §14.8).

:func:`render_openmetrics` turns the metrics registry's JSONL lines into
one OpenMetrics text snapshot: counters become ``*_total`` samples,
gauges expose their last set value, and histograms map the registry's
log-spaced bucket edges onto cumulative ``le``-labelled buckets (plus
the ``+Inf`` overflow) with ``*_sum`` / ``*_count``.  The streaming sink
rotates the snapshot atomically on every flush tick, so a scraper (or
``curl``) pointed at ``results/<run_id>/telemetry/metrics.prom`` always
reads a consistent point-in-time exposition.

:func:`parse_openmetrics` / :func:`lint_openmetrics` are the inverse
direction: a small line parser plus the metric-name and structure lint
CI runs against the quickstart run's snapshot (``repro_torch obs --validate``
applies the same checks).

Import-light on purpose — pure string work over dicts, no torch, no numpy.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

#: OpenMetrics metric/label name grammar (the lint's anchor).
_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")

#: every exported sample is namespaced under this prefix
PREFIX = "repro"


def metric_name(name: str) -> str:
    """Registry name -> OpenMetrics name (``serve.latency_s`` ->
    ``repro_serve_latency_s``)."""
    safe = _SANITIZE_RE.sub("_", name)
    if not safe or not _NAME_RE.match(safe):
        safe = f"_{safe}"
    return f"{PREFIX}_{safe}"


def _fmt(value: float) -> str:
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_le(edge: float) -> str:
    return format(float(edge), ".6g")


def render_openmetrics(
    lines: List[Dict[str, Any]], *, meta: Optional[Dict[str, Any]] = None
) -> str:
    """One OpenMetrics text snapshot from ``MetricsRegistry.to_lines()``.

    Families are name-sorted; the snapshot ends with the mandatory
    ``# EOF`` terminator.  ``meta`` (when given) contributes a leading
    comment naming the run — comments are legal between families.
    """
    out: List[str] = []
    if meta:
        run_id = meta.get("run_id") or "?"
        out.append(f"# run_id {run_id} schema {meta.get('schema', '?')}")
    for line in sorted(lines, key=lambda d: d.get("name", "")):
        kind = line.get("type")
        name = metric_name(line["name"])
        if kind == "counter":
            out.append(f"# TYPE {name} counter")
            out.append(f"{name}_total {_fmt(line['value'])}")
        elif kind == "gauge":
            if line.get("last") is None:
                continue  # a gauge that was never set has no sample
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name} {_fmt(line['last'])}")
        elif kind == "histogram":
            out.append(f"# TYPE {name} histogram")
            cum = 0
            counts = line["counts"]
            for edge, c in zip(line["edges"], counts):
                cum += c
                out.append(
                    f'{name}_bucket{{le="{_fmt_le(edge)}"}} {_fmt(cum)}'
                )
            out.append(f'{name}_bucket{{le="+Inf"}} {_fmt(line["count"])}')
            out.append(f"{name}_sum {_fmt(line['sum'])}")
            out.append(f"{name}_count {_fmt(line['count'])}")
    out.append("# EOF")
    return "\n".join(out) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[^\s{]+)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)\s*$"
)


def parse_openmetrics(
    text: str,
) -> Dict[str, Dict[str, Any]]:
    """Parse an OpenMetrics snapshot into ``{family: {type, samples}}``.

    ``samples`` is a list of ``(sample_name, labels, value)`` tuples.
    Raises ``ValueError`` on lines that are neither comments, blanks,
    nor well-formed samples.
    """
    families: Dict[str, Dict[str, Any]] = {}
    current: Optional[str] = None
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                current = parts[2]
                families[current] = {"type": parts[3], "samples": []}
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: not an OpenMetrics sample: {raw!r}")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            for pair in m.group("labels").split(","):
                if "=" not in pair:
                    raise ValueError(f"line {i}: bad label pair {pair!r}")
                k, v = pair.split("=", 1)
                labels[k.strip()] = v.strip().strip('"')
        try:
            value = (
                math.inf
                if m.group("value") == "+Inf"
                else float(m.group("value"))
            )
        except ValueError as e:
            raise ValueError(
                f"line {i}: bad sample value {m.group('value')!r}"
            ) from e
        sample = (m.group("name"), labels, value)
        family = current if current and m.group("name").startswith(current) else None
        if family is None:
            # an undeclared family: record it so the lint can flag it
            family = m.group("name")
            families.setdefault(family, {"type": None, "samples": []})
        families[family]["samples"].append(sample)
    return families


def lint_openmetrics(text: str) -> List[str]:
    """Structure + metric-name lint; returns problems ([] = clean).

    Checks: the ``# EOF`` terminator, sample-name grammar, a ``# TYPE``
    declaration per family, counter samples carrying the ``_total``
    suffix, histogram buckets cumulative with a ``+Inf`` bucket matching
    ``_count``.
    """
    problems: List[str] = []
    if not text.rstrip("\n").endswith("# EOF"):
        problems.append("missing '# EOF' terminator")
    try:
        families = parse_openmetrics(text)
    except ValueError as e:
        return problems + [str(e)]
    for family, info in sorted(families.items()):
        if not _NAME_RE.match(family):
            problems.append(f"{family}: invalid metric name")
        if info["type"] is None:
            problems.append(f"{family}: sample without a # TYPE declaration")
            continue
        names = [s[0] for s in info["samples"]]
        if info["type"] == "counter":
            for n in names:
                if not n.endswith("_total"):
                    problems.append(
                        f"{family}: counter sample {n!r} lacks _total suffix"
                    )
        elif info["type"] == "histogram":
            buckets: List[Tuple[float, float]] = []
            count = None
            for n, labels, v in info["samples"]:
                if n == f"{family}_bucket":
                    le = labels.get("le")
                    if le is None:
                        problems.append(f"{family}: bucket without le label")
                        continue
                    buckets.append(
                        (math.inf if le == "+Inf" else float(le), v)
                    )
                elif n == f"{family}_count":
                    count = v
            cum = [v for _, v in buckets]
            if cum != sorted(cum):
                problems.append(f"{family}: bucket counts not cumulative")
            if not buckets or buckets[-1][0] != math.inf:
                problems.append(f"{family}: missing +Inf bucket")
            elif count is not None and buckets[-1][1] != count:
                problems.append(
                    f"{family}: +Inf bucket {buckets[-1][1]} != "
                    f"_count {count}"
                )
    return problems
