"""Run-summary assembly + text rendering for ``repro_torch obs`` (DESIGN.md §14.5).

:func:`summarize` folds raw telemetry records (meta + span/event lines +
metric lines) into one JSON-able digest: phase durations, the solve
convergence curve, latency percentile tables, cache hit rates, and
queue/batch occupancy.  :func:`render` turns that digest into the text
report the CLI prints.  Both are pure functions over dicts so they work
identically on an in-memory :class:`~repro_torch.obs.telemetry.Telemetry` and
on a ``results/<run_id>/telemetry/`` directory read back from disk.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple


def _segment_names(path: str) -> List[str]:
    """Live-stream segment files (``events-NNNN.jsonl``), in write order."""
    return sorted(
        n
        for n in os.listdir(path)
        if n.startswith("events-") and n.endswith(".jsonl")
    )


def load_dir(path: str) -> Tuple[Dict, List[Dict], List[Dict]]:
    """Read a telemetry directory back into (meta, events, metric lines).

    Reads the consolidated ``events.jsonl`` plus any live-stream segments
    still on disk (a run being tailed mid-flight has only segments; a
    killed run may have both), deduplicating records by ``(kind, id)``.
    A torn *final* line — the snapshot raced the writer — is tolerated
    and counted in ``meta["truncated_lines"]``; a bad line anywhere else
    is real corruption and still raises.
    """
    truncated = 0

    def read_jsonl(name: str) -> List[Dict]:
        nonlocal truncated
        fp = os.path.join(path, name)
        if not os.path.isfile(fp):
            return []
        out = []
        raw = [ln.strip() for ln in open(fp)]
        raw = [ln for ln in raw if ln]
        for i, line in enumerate(raw):
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(raw) - 1:
                    truncated += 1
                    continue
                raise
        return out

    events = read_jsonl("events.jsonl")
    seen = {(r.get("kind"), r.get("id")) for r in events if "id" in r}
    for name in _segment_names(path):
        for r in read_jsonl(name):
            key = (r.get("kind"), r.get("id"))
            if "id" in r and key in seen:
                continue
            if "id" in r:
                seen.add(key)
            events.append(r)
    metrics = read_jsonl("metrics.jsonl")
    meta = next((r for r in events + metrics if r.get("kind") == "meta"), {})
    if truncated:
        meta = dict(meta)
        meta["truncated_lines"] = truncated
    return (
        meta,
        [r for r in events if r.get("kind") in ("span", "event")],
        [r for r in metrics if r.get("kind") == "metric"],
    )


def _series(metric: Optional[Dict]) -> List[float]:
    if not metric:
        return []
    return [float(v) for _, v in metric.get("series", [])]


def summarize(meta: Dict, events: List[Dict], metrics: List[Dict]) -> Dict[str, Any]:
    """Fold raw telemetry records into the run digest."""
    by_name = {m["name"]: m for m in metrics}
    counters = {
        m["name"]: m["value"] for m in metrics if m.get("type") == "counter"
    }
    out: Dict[str, Any] = {
        "run_id": meta.get("run_id"),
        "level": meta.get("level"),
        "counters": counters,
    }
    if meta.get("truncated_lines"):
        out["truncated_lines"] = meta["truncated_lines"]

    spans: Dict[str, int] = {}
    phases = []
    for record in events:
        if record.get("kind") != "span":
            continue
        kind = record.get("span", "?")
        spans[kind] = spans.get(kind, 0) + 1
        if kind == "phase":
            phases.append(
                {"name": record.get("name"), "dur_s": record.get("dur_s")}
            )
    out["spans"] = spans
    out["events"] = sum(1 for r in events if r.get("kind") == "event")
    if phases:
        out["phases"] = phases

    residuals = _series(by_name.get("solve.residual"))
    if residuals:
        out["convergence"] = {
            "supersteps": len(residuals),
            "first_residual": residuals[0],
            "last_residual": residuals[-1],
            "residuals": residuals,
            "active_columns": _series(by_name.get("solve.active_columns")),
        }

    latency = {}
    for m in metrics:
        if m.get("type") != "histogram" or not m.get("count"):
            continue
        latency[m["name"]] = {
            k: m.get(k) for k in ("count", "p50", "p95", "p99", "min", "max")
        }
    if latency:
        out["latency"] = latency

    hits = counters.get("serve.cache.hits", 0)
    misses = counters.get("serve.cache.misses", 0)
    if hits or misses:
        out["cache"] = {
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / (hits + misses),
            "evictions": counters.get("serve.cache.evictions", 0),
            "invalidations": counters.get("serve.cache.invalidations", 0),
        }

    breaches = counters.get("obs.slo.breaches", 0)
    recoveries = counters.get("obs.slo.recoveries", 0)
    if breaches or recoveries:
        burning = _series(by_name.get("obs.slo.burning"))
        out["slo"] = {
            "breaches": breaches,
            "recoveries": recoveries,
            "burning": bool(burning and burning[-1]),
        }

    ft_keys = {
        "checkpoints": "ft.checkpoints",
        "resumes": "ft.resumes",
        "retries": "ft.retries",
        "restores": "ft.restores",
        "straggler_flags": "ft.straggler_flags",
        "remeshes": "ft.remeshes",
    }
    if any(counters.get(name) for name in ft_keys.values()):
        out["ft"] = {
            short: counters.get(name, 0) for short, name in ft_keys.items()
        }

    depth = _series(by_name.get("serve.queue_depth"))
    if depth:
        out["queue"] = {
            "max_depth": max(depth),
            "mean_depth": sum(depth) / len(depth),
        }
    occupancy = _series(by_name.get("serve.batch_occupancy"))
    if occupancy:
        out["batch"] = {
            "batches": len(occupancy),
            "mean_occupancy": sum(occupancy) / len(occupancy),
            "mean_size": (
                sum(sizes) / len(sizes)
                if (sizes := _series(by_name.get("serve.batch_size")))
                else None
            ),
        }
    return out


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v * 1e3:.2f}ms"


def render(summary: Dict[str, Any]) -> str:
    """The ``repro_torch obs <run_id>`` text report."""
    lines = [
        f"run {summary.get('run_id') or '?'}  level={summary.get('level') or '?'}"
    ]
    for phase in summary.get("phases", []):
        lines.append(f"  phase {phase['name']}: {phase['dur_s']:.3f}s")

    conv = summary.get("convergence")
    if conv:
        lines.append(
            f"convergence: {conv['supersteps']} supersteps, residual "
            f"{conv['first_residual']:.3e} -> {conv['last_residual']:.3e}"
        )
        curve = conv["residuals"]
        shown = curve if len(curve) <= 12 else curve[:6] + curve[-6:]
        gap = "" if len(curve) <= 12 else " ..."
        head = " ".join(f"{r:.2e}" for r in shown[:6])
        tail = " ".join(f"{r:.2e}" for r in shown[6:])
        lines.append(f"  curve: {head}{gap} {tail}".rstrip())

    for name, h in sorted(summary.get("latency", {}).items()):
        lines.append(
            f"latency {name}: n={h['count']} p50={_fmt_ms(h['p50'])} "
            f"p95={_fmt_ms(h['p95'])} p99={_fmt_ms(h['p99'])} "
            f"max={_fmt_ms(h['max'])}"
        )

    cache = summary.get("cache")
    if cache:
        lines.append(
            f"cache: hits={cache['hits']} misses={cache['misses']} "
            f"hit_rate={cache['hit_rate']:.2%} "
            f"evictions={cache['evictions']} demoted={cache['invalidations']}"
        )

    slo = summary.get("slo")
    if slo:
        state = "BURNING" if slo["burning"] else "ok"
        lines.append(
            f"slo: breaches={slo['breaches']} recoveries={slo['recoveries']} "
            f"state={state}"
        )

    ft = summary.get("ft")
    if ft:
        lines.append(
            f"ft: checkpoints={ft['checkpoints']} resumes={ft['resumes']} "
            f"retries={ft['retries']} restores={ft['restores']} "
            f"straggler_flags={ft['straggler_flags']}"
            + (f" remeshes={ft['remeshes']}" if ft.get("remeshes") else "")
        )

    queue = summary.get("queue")
    if queue:
        lines.append(
            f"queue: max_depth={queue['max_depth']:.0f} "
            f"mean_depth={queue['mean_depth']:.1f}"
        )
    batch = summary.get("batch")
    if batch:
        size = batch.get("mean_size")
        lines.append(
            f"batches: {batch['batches']} "
            f"mean_occupancy={batch['mean_occupancy']:.2f}"
            + (f" mean_size={size:.1f}" if size is not None else "")
        )

    spans = summary.get("spans", {})
    if spans or summary.get("events"):
        span_txt = " ".join(f"{k}={v}" for k, v in sorted(spans.items()))
        lines.append(f"records: spans[{span_txt}] events={summary.get('events', 0)}")
    if summary.get("truncated_lines"):
        lines.append(
            f"warning: {summary['truncated_lines']} truncated trailing "
            "line(s) skipped (snapshot raced the writer)"
        )
    return "\n".join(lines)
