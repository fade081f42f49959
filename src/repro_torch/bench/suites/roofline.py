"""The ``roofline`` suite: dry-run census records -> BENCH records.

The port's copy of the reference's suite (``benchmarks/roofline.py``
``artifact_path`` / ``records`` / ``register``).  By default it reads
the committed sample, ``benchmarks/data/dryrun_sample.jsonl`` (three
``dhlp-bio`` records of the reference's XLA census), so that the suite's
keys and strict metrics stay reproducible against
``benchmarks/baseline.json``; ``REPRO_DRYRUN_ARTIFACTS`` names another
census file instead, such as the port's own
(``results/<run_id>/telemetry/dryrun.jsonl`` of a ``dryrun`` section).

The strict metrics are the census's FLOPs, HBM bytes and collective
bytes per device, which do not depend on any peak.  The derived times
are against the H100 peaks of the card the pass runs on
(:func:`repro_torch.bench.roofline.device_peak_model`; the SXM part's on
the CPU), never a TPU's.
"""
from __future__ import annotations

import os
from typing import List

from repro_torch.bench.registry import register_suite
from repro_torch.bench.roofline import analyze, device_peak_model, load
from repro_torch.bench.schema import BenchRecord
from repro_torch.bench.timing import stats_from_samples

SAMPLE_ARTIFACTS = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "..",
    "benchmarks", "data", "dryrun_sample.jsonl"))


def artifact_path() -> str:
    """The census file the suite reads: ``REPRO_DRYRUN_ARTIFACTS`` when
    set, else the committed sample (a leftover local sweep never changes
    the suite's identity silently)."""
    override = os.environ.get("REPRO_DRYRUN_ARTIFACTS")
    if override:
        print(f"roofline: reading artifacts from {override} (REPRO_DRYRUN_ARTIFACTS)",
              flush=True)
        return override
    return SAMPLE_ARTIFACTS


def _hbm_bytes(device):
    """The card's memory, or None (the peak table's 80 GB) off the card."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    return torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else None


@register_suite("roofline", description="roofline terms from multi-pod dry-run artifacts")
def records(fast: bool = True, device=None) -> List[BenchRecord]:
    """One BENCH record per ``ok`` (arch × shape × mesh) census record.

    ``stats`` carries the record's trace (and, for XLA records, compile)
    seconds, the only clocked quantity a dry run has; the roofline terms
    land in ``derived``, the per-device census strict."""
    path = artifact_path()
    model, hbm = device_peak_model(device), _hbm_bytes(device)
    out: List[BenchRecord] = []
    for rec in load(path):
        if rec.get("status") != "ok":
            print(f"roofline: skipped {rec.get('arch')}/{rec.get('shape')}@{rec.get('mesh')} "
                  f"(status={rec.get('status')})", flush=True)
            continue
        a = analyze(rec, model, hbm)
        wall = float(rec.get("lower_s", 0.0)) + float(rec.get("compile_s", 0.0))
        derived = {k: a[k] for k in (
            "flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
            "t_compute_s", "t_memory_s", "t_collective_s", "roofline_bound_s",
            "compute_fraction")}
        out.append(BenchRecord(
            suite="roofline",
            name=f"{a['arch']}/{a['shape']}",
            backend=a["mesh"],
            params={"chips": a["chips"], "kind": a.get("kind"), "bottleneck": a["bottleneck"],
                    "artifact": "sample" if path == SAMPLE_ARTIFACTS else "live",
                    "peak_model": model},
            stats=stats_from_samples([wall]).to_dict(),
            derived=derived,
            strict=["flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device"],
        ))
    return out
