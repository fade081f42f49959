"""Report assembly and ``BENCH_torch_<label>.json`` / ``results/`` writing.

The record and report schema is the reference package's (``repro.bench``,
``SCHEMA_VERSION`` 1), so a report written by either package validates
under the other.  The file names carry a ``torch_`` prefix: both packages
run ``examples/specs/bench_ci.json`` with the label ``ci``, and neither
may overwrite the other's report.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from typing import Dict, List, Optional, Union

from repro_torch.bench.schema import (
    SCHEMA_VERSION,
    BenchRecord,
    record_key,
    validate_report,
)
from repro_torch.device import resolve_device

#: prefix of the port's report files (``BENCH_torch_ci.json``)
FILE_PREFIX = "torch_"


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), or why it could not say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=60,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {type(e).__name__}"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "unavailable: no output"


def environment_info(device=None) -> Dict[str, object]:
    """Fingerprint of the machine the run happened on.

    ``device`` is where the suites ran (``None``: ``cuda:0``).  On a card the
    record names it (``torch.cuda.get_device_name``), its compute
    capability, SM count and power limit; ``repro_torch.bench.compare``
    only applies the *timing* gate when the baseline and candidate
    fingerprints match — correctness-derived metrics gate
    unconditionally (DESIGN.md §10).
    """
    import torch

    info: Dict[str, object] = {
        "platform": sys.platform,
        "machine": platform.machine(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count() or 0,
        # operator-declared runner class (e.g. "gh-ubuntu-large"); CPU
        # platform/machine alone cannot distinguish a laptop from a CI
        # runner, and wall times must not gate across host classes
        "host_class": os.environ.get("BENCH_HOST_CLASS", "unspecified"),
        "backend": "cpu",
        "device_kind": "cpu",
        "device_count": 1,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    dev = resolve_device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        info.update(
            {
                "backend": "cuda",
                "device_kind": torch.cuda.get_device_name(dev),
                "device_count": torch.cuda.device_count(),
                "compute_capability": f"{props.major}.{props.minor}",
                "sm_count": props.multi_processor_count,
                "power_limit": power_limit(),
            }
        )
    return info


def env_fingerprint(env: Dict[str, object]) -> tuple:
    """The subset of the environment that makes wall times comparable.

    ``cpu_count`` and ``host_class`` are included because on CPU backends
    platform/machine/device_kind are identical across almost all linux
    x86_64 hosts — without a host-class axis the timing gate would fire
    against baselines recorded on different hardware.  The compute
    capability and the power limit keep a card set below its full power
    (or another card of the same name) from gating against a baseline
    taken at full power.
    """
    keys = (
        "platform",
        "machine",
        "backend",
        "device_kind",
        "cpu_count",
        "host_class",
        "compute_capability",
        "power_limit",
    )
    return tuple(env.get(k) for k in keys)


class BenchReport:
    """Accumulates records across suites and writes the two artifacts:

    * ``BENCH_torch_<label>.json`` in ``root`` (default: the working
      directory, never a directory above it) — the machine-readable
      trajectory point ``compare`` gates on;
    * ``results/torch_<label>_<timestamp>.json`` — an append-only per-run copy.
    """

    def __init__(
        self,
        label: str,
        *,
        environment: Optional[Dict[str, object]] = None,
        created_unix: Optional[float] = None,
    ):
        self.label = label
        self.environment = environment or environment_info()
        self.created_unix = (
            time.time() if created_unix is None else float(created_unix)
        )
        self.records: List[BenchRecord] = []
        self.errors: List[Dict[str, str]] = []

    def add(self, record: BenchRecord) -> None:
        key = record_key(record)
        if any(record_key(r) == key for r in self.records):
            raise ValueError(f"duplicate record key {key!r}")
        self.records.append(record)

    def extend(self, records) -> None:
        for r in records:
            self.add(r)

    def add_error(self, suite: str, error: str) -> None:
        """A suite that failed to produce records (driver exits nonzero)."""
        self.errors.append({"suite": suite, "error": error})

    @property
    def suites(self) -> List[str]:
        return sorted({r.suite for r in self.records})

    def to_dict(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "schema_version": SCHEMA_VERSION,
            "label": self.label,
            "created_unix": self.created_unix,
            "environment": self.environment,
            "records": [r.to_dict() for r in self.records],
        }
        if self.errors:
            d["errors"] = list(self.errors)
        return d

    def write(
        self,
        root: Optional[str] = None,
        *,
        results_dir: Optional[str] = None,
        validate: bool = True,
    ) -> List[str]:
        """Write both artifacts; returns the paths written."""
        doc = self.to_dict()
        if validate:
            validate_report(doc)
        root = root or os.getcwd()
        name = f"{FILE_PREFIX}{self.label}"
        paths = [os.path.join(root, f"BENCH_{name}.json")]
        results_dir = results_dir or os.path.join(root, "results")
        os.makedirs(results_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(self.created_unix))
        paths.append(os.path.join(results_dir, f"{name}_{stamp}.json"))
        blob = json.dumps(doc, indent=2, sort_keys=False)
        for p in paths:
            with open(p, "w") as f:
                f.write(blob + "\n")
        return paths


def telemetry_digest(telemetry) -> Optional[Dict[str, object]]:
    """Compress a :class:`repro_torch.obs.Telemetry` (or a pre-built
    summary dict) into the compact form embedded in BENCH records.

    Keeps the scalar roll-ups (counters, phase durations, histogram
    percentiles) and drops the raw series — BENCH files are diffed and
    committed, so per-tick gauge series stay in the run's
    ``telemetry/`` artifacts only (DESIGN.md §14.5).  Returns ``None``
    for a disabled telemetry object so callers can assign the record
    field unconditionally.
    """
    if telemetry is None:
        return None
    summary = telemetry if isinstance(telemetry, dict) else None
    if summary is None:
        if not getattr(telemetry, "enabled", False):
            return None
        summary = telemetry.summary()
    digest: Dict[str, object] = {}
    for key in ("level", "counters", "phases", "latency", "cache", "queue", "batch"):
        if summary.get(key):
            digest[key] = summary[key]
    conv = summary.get("convergence")
    if conv:
        digest["convergence"] = {
            k: conv.get(k)
            for k in ("supersteps", "first_residual", "last_residual")
        }
    return digest or None


def load_report(path: str, *, validate: bool = True) -> Dict[str, object]:
    with open(path) as f:
        doc = json.load(f)
    if validate:
        validate_report(doc)
    return doc


def legacy_csv_line(record: Union[BenchRecord, Dict[str, object]]) -> str:
    """The seed scripts' ``name,us_per_call,derived`` stdout format, kept
    so eyeballing a run still works while JSON is the machine interface."""
    if isinstance(record, BenchRecord):
        record = record.to_dict()
    if record.get("error") is not None:
        return f"{record['suite']}/{record['name']},0,error={record['error'][:60]}"
    us = record["stats"]["median_s"] * 1e6
    derived = ";".join(
        f"{k}={v:.6g}" for k, v in sorted(record.get("derived", {}).items())
    )
    return f"{record['suite']}/{record['name']},{us:.0f},{derived}"
