"""Roofline terms on an NVIDIA H100: the dry run's census and the LP round.

Two kinds of cells get roofline terms here, against an H100 peak table
picked from the card's name (:func:`device_peak_model`):

* the dry run's census records (:mod:`repro_torch.launch.dryrun`, or the
  reference's XLA records in ``benchmarks/data/dryrun_sample.jsonl``):
  :func:`corrected_costs`, :func:`collective_bytes` and :func:`analyze`,
  the reference's ``benchmarks/roofline.py`` functions, with the card's
  peaks in place of its TPU constants.  Per (arch × shape × mesh) cell:

      compute term    = FLOPs per device / peak FLOP/s
      memory term     = HBM bytes per device / HBM bytes/s
      collective term = collective bytes per device / link bytes/s

  The FLOPs, HBM bytes and collective bytes per device do not depend on
  the peaks.  ``bench/suites/roofline.py`` turns each record into a
  BENCH record;
* the kernel-variant cells (``repro_torch.bench.suites.kernel_variants``),
  which run live: an analytic per-round cost model (:func:`lp_round_cost`,
  the reference's unchanged) against the measured wall clock.

Peaks are NVIDIA's H100 data sheet (dense rates, no sparsity), at the
full power limit: the SXM5 part (67 TFLOP/s float32 outside the tensor
cores and 989 TFLOP/s bf16 on them, 3.35 TB/s HBM3, 80 GB, NVLink 4 at
450 GB/s each way — the peaks ``PERF.md`` §6's bounds use) and the PCIe
part (51 and 756 TFLOP/s, 2.0 TB/s HBM2e, 80 GB, PCIe Gen5 at 64 GB/s each
way).  On the CPU the terms are computed against the SXM table and are
diagnostics, not predictions.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

#: name -> f32 FLOP/s outside the tensor cores, bf16 FLOP/s on them, HBM
#: bytes/s, HBM bytes, and the bytes/s one way of the card's link to its
#: peers
PEAKS: Dict[str, Dict[str, float]] = {
    "h100_sxm": {"flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12,
                 "hbm_bytes": 80e9, "link_bytes_per_s": 450e9},
    "h100_pcie": {"flops": 51e12, "bf16_flops": 756e12, "bytes_per_s": 2.0e12,
                  "hbm_bytes": 80e9, "link_bytes_per_s": 64e9},
}

#: chips of the production meshes (the reference's)
CHIPS = {"single": 256, "multi": 512}


def peak_model(device_name: str) -> str:
    """The :data:`PEAKS` key for a card's name; raises for any other card."""
    name = device_name.upper()
    if "H100" in name and "PCIE" in name:
        return "h100_pcie"
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return "h100_sxm"
    raise ValueError(
        f"no peak table for {device_name!r}: repro_torch.bench.roofline "
        f"knows the H100 SXM and PCIe parts ({', '.join(sorted(PEAKS))})"
    )


def device_peak_model(device=None) -> str:
    """The peak model of the card ``device`` names (``None``: ``cuda:0``);
    the SXM table when the caller asked for the CPU."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return "h100_sxm"
    return peak_model(torch.cuda.get_device_name(dev))


def lp_round_cost(
    *, nnz: int, num_nodes: int, s: int, storage_bytes: int = 4
) -> Dict[str, float]:
    """Analytic FLOPs / HBM bytes for ONE fused LP round.

    The fused superstep computes ``c*base + A_eff @ F`` plus the residual
    reduction: 2 FLOPs per stored edge per seed column (multiply-add),
    plus the seed-term axpy and the ``|Fn − prev|`` max-reduce (2·N·S
    each).  Bytes: edge structure (int32 index + weight) read once, one
    gathered label row per edge, and base/prev reads + label write per
    node row (accumulation is f32 regardless of storage dtype, so the
    row-wise traffic stays 4-byte; ``storage_bytes`` scales the gather
    panel and the weights — the bf16 lever).
    """
    flops = 2.0 * nnz * s + 4.0 * num_nodes * s
    hbytes = (
        nnz * (4.0 + storage_bytes)  # nbr index + weight
        + nnz * storage_bytes * s  # gathered label rows
        + num_nodes * 4.0 * s * 3.0  # base + prev reads, label write
    )
    return {"flops": flops, "bytes": hbytes}


def achieved_vs_peak(
    round_s: float, cost: Dict[str, float], model: str = "h100_sxm"
) -> Dict[str, float]:
    """Achieved FLOP/s and bandwidth vs the ``model`` peaks of :data:`PEAKS`.

    ``round_s`` is the measured wall time of one LP round.
    """
    peaks = PEAKS[model]
    t = max(round_s, 1e-12)
    return {
        "achieved_gflops": cost["flops"] / t / 1e9,
        "achieved_gbps": cost["bytes"] / t / 1e9,
        "frac_peak_flops": cost["flops"] / t / peaks["flops"],
        "frac_peak_bw": cost["bytes"] / t / peaks["bytes_per_s"],
    }


# ---------------------------------------------------------------------------
# the dry run's census -> roofline terms (the reference's benchmarks/roofline.py)
# ---------------------------------------------------------------------------
def corrected_costs(rec: Dict[str, Any]) -> Dict[str, float]:
    """Per-device FLOPs / HBM bytes with the scan-body extrapolation
    ``f(L) = f(0) + L·(f(1) − f(0))`` from the trip-0/1 probes."""
    cost = rec.get("cost", {})
    flops = float(cost.get("flops", 0.0))
    hbytes = float(cost.get("bytes accessed", 0.0))
    trip = rec.get("meta", {}).get("scan_trip")
    probe = rec.get("probe") or {}
    p0, p1 = probe.get("0"), probe.get("1")
    if trip and p0 and p1 and "flops" in p0 and "flops" in p1:
        flops = p0["flops"] + trip * (p1["flops"] - p0["flops"])
        hbytes = p0["bytes"] + trip * (p1["bytes"] - p0["bytes"])
    return {"flops": flops, "hbm_bytes": hbytes}


def collective_bytes(rec: Dict[str, Any]) -> Dict[str, float]:
    """Per-device collective bytes (the loop bucket times the trip count)."""
    trip = rec.get("meta", {}).get("scan_trip") or 1
    total, per_kind = 0.0, {}
    for kind, c in rec.get("collectives", {}).items():
        if not isinstance(c, dict):
            continue
        b = c.get("bytes", 0) + trip * c.get("loop_bytes", 0)
        per_kind[kind] = b
        total += b
    return {"total": total, **per_kind}


def analyze(rec: Dict[str, Any], model: str = "h100_sxm",
            hbm_bytes: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """The roofline terms of an ``ok`` census record against the ``model``
    peaks of :data:`PEAKS` (None for any other status).  The compute peak
    is the bf16 one for a record of bf16 or f16 inputs (its ``dtype``),
    else the f32 one.  ``fits_hbm`` (where the record has a temp size)
    compares with ``hbm_bytes``, the card's memory, by default the
    table's."""
    if rec.get("status") != "ok":
        return None
    peaks = PEAKS[model]
    half = rec.get("dtype") in ("bfloat16", "float16")
    peak_flops = peaks["bf16_flops"] if half else peaks["flops"]
    chips = CHIPS[rec["mesh"]]
    cost = corrected_costs(rec)
    col = collective_bytes(rec)
    # per-device programs on both sides: the terms are per-device time
    terms = {
        "compute": cost["flops"] / peak_flops,
        "memory": cost["hbm_bytes"] / peaks["bytes_per_s"],
        "collective": col["total"] / peaks["link_bytes_per_s"],
    }
    bottleneck = max(terms, key=terms.get)
    bound = max(terms.values())
    out = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec.get("kind"), "chips": chips, "peak_model": model,
        "flops_per_device": cost["flops"],
        "hbm_bytes_per_device": cost["hbm_bytes"],
        "collective_bytes_per_device": col["total"],
        "t_compute_s": terms["compute"],
        "t_memory_s": terms["memory"],
        "t_collective_s": terms["collective"],
        "bottleneck": bottleneck,
        "roofline_bound_s": bound,
        # the share of the bound the compute term holds (1.0 = at the
        # compute roofline)
        "compute_fraction": terms["compute"] / bound if bound > 0 else 0.0,
        "collectives": {k: v for k, v in col.items() if k != "total"},
    }
    model_flops = rec.get("meta", {}).get("model_flops")
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / max(cost["flops"] * chips, 1.0)
    mem = rec.get("memory", {})
    if "temp_size_in_bytes" in mem:
        out["temp_bytes"] = mem["temp_size_in_bytes"]
        out["arg_bytes"] = mem.get("argument_size_in_bytes", 0)
        out["fits_hbm"] = (mem["temp_size_in_bytes"] + mem.get("argument_size_in_bytes", 0)
                           < (peaks["hbm_bytes"] if hbm_bytes is None else hbm_bytes))
    return out


def load(path: str) -> List[Dict[str, Any]]:
    """A dry-run census file in either format: bare-record JSONL, or the
    telemetry artifact format (``telemetry/dryrun.jsonl``: a leading
    ``meta`` line skipped, each ``event`` line's ``attrs`` the record)."""
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            kind = rec.get("kind") if isinstance(rec, dict) else None
            if kind == "meta":
                continue
            if kind == "event":
                rec = rec.get("attrs", {})
            rows.append(rec)
    return rows
