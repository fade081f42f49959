"""Unified benchmark harness: timing discipline, one versioned record
schema (the reference's: a report written by either package validates
under the other), machine-readable ``BENCH_torch_<label>.json`` reports,
a suite registry, the LP backend matrix, and a baseline comparator.

Every suite under ``repro_torch.bench.suites`` registers itself here and
emits :class:`BenchRecord` rows; ``repro_torch.bench.driver.run_bench``
runs the registered suites on a device (the card unless the CPU is asked
for), writes the report, and counts failures.  ``python -m
repro_torch.bench.compare`` diffs a report against a baseline (DESIGN.md
§10).
"""
from repro_torch.bench.registry import BenchSuite, all_suites, get_suite, register_suite
from repro_torch.bench.report import BenchReport, environment_info, load_report
from repro_torch.bench.schema import (
    SCHEMA_VERSION,
    BenchRecord,
    SchemaError,
    record_key,
    validate_record,
    validate_report,
)
from repro_torch.bench.timing import (
    TimingStats,
    stats_from_samples,
    time_callable,
    time_cuda_events,
)

__all__ = [
    "SCHEMA_VERSION",
    "BenchRecord",
    "BenchReport",
    "BenchSuite",
    "SchemaError",
    "TimingStats",
    "all_suites",
    "environment_info",
    "get_suite",
    "load_report",
    "record_key",
    "register_suite",
    "stats_from_samples",
    "time_callable",
    "time_cuda_events",
    "validate_record",
    "validate_report",
]
