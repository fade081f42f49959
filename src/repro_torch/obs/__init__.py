"""Observability subsystem: telemetry, metrics, profiler hooks (DESIGN.md §14).

The cross-cutting layer a :class:`~repro_torch.api.session.Session`
threads through solve and serve when the spec carries an ``obs``
section:

* :mod:`repro_torch.obs.telemetry` — structured spans/events + the level gate;
* :mod:`repro_torch.obs.metrics`   — counters, gauges, log-bucket histograms;
* :mod:`repro_torch.obs.schema`    — JSONL schema validation (``--validate``);
* :mod:`repro_torch.obs.export`    — OpenMetrics text snapshots (render/parse/lint);
* :mod:`repro_torch.obs.slo`       — SLO watchdog + serve degradation ladder;
* :mod:`repro_torch.obs.solve`     — the observed per-superstep solve loop;
* :mod:`repro_torch.obs.profiler`  — ``torch.profiler`` phases + kernel timing;
* :mod:`repro_torch.obs.summary`   — digest + text rendering for ``repro_torch obs``.

Import-light on purpose: importing :mod:`repro_torch.obs` loads none of
the engines or kernels and initialises no card (the profiler and the
observed solve are imported where they are used), so the CLI can
validate telemetry artifacts without touching a card.
"""

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_index,
)
from repro_torch.obs.export import lint_openmetrics, parse_openmetrics, render_openmetrics
from repro_torch.obs.schema import TelemetryError, validate_dir, validate_file, validate_line
from repro_torch.obs.slo import ServeDegradation, SLOWatchdog
from repro_torch.obs.telemetry import LEVELS, SCHEMA, Span, Telemetry

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "LEVELS",
    "MetricsRegistry",
    "SCHEMA",
    "SLOWatchdog",
    "ServeDegradation",
    "Span",
    "Telemetry",
    "TelemetryError",
    "bucket_index",
    "lint_openmetrics",
    "parse_openmetrics",
    "render_openmetrics",
    "validate_dir",
    "validate_file",
    "validate_line",
]
