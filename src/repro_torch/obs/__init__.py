"""Observability: telemetry and metrics (DESIGN.md §14).

The cross-cutting layer a :class:`~repro_torch.api.session.Session`
threads through solve and serve:

* :mod:`repro_torch.obs.telemetry` — structured spans/events + the level gate;
* :mod:`repro_torch.obs.metrics`   — counters, gauges, log-bucket histograms.

The rest of ``repro.obs`` (schema, export, slo, solve, summary, profiler)
is queue item A.4 of ``ROADMAP.md``; until it lands, a spec whose ``obs``
level is not ``"off"`` raises ``NotImplementedError`` in the Session.
"""

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_index,
)
from repro_torch.obs.telemetry import LEVELS, SCHEMA, Span, Telemetry

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "LEVELS",
    "MetricsRegistry",
    "SCHEMA",
    "Span",
    "Telemetry",
    "bucket_index",
]
