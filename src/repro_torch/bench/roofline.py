"""LP-round achieved-vs-peak terms on an NVIDIA H100.

The kernel-variant cells (``repro_torch.bench.suites.kernel_variants``)
run live, so their roofline terms come from an analytic per-round cost
model (:func:`lp_round_cost`, the reference's unchanged) evaluated
against the measured wall clock and an H100 peak table picked from the
card's name (:func:`device_peak_model`).

Peaks are NVIDIA's H100 data sheet (dense rates, no sparsity), at the
full power limit: the SXM5 part (67 TFLOP/s float32 outside the tensor
cores, 3.35 TB/s HBM3 — the peaks ``PERF.md`` §6's bounds use) and the
PCIe part (51 TFLOP/s float32, 2.0 TB/s HBM2e).  On the CPU the
fractions are computed against the SXM table and are diagnostics, not
predictions, as the reference's TPU-v5e fractions are on its CPU.

The reference's dry-run census (``benchmarks/roofline.py``, its
``roofline`` suite) reads compiled XLA artifacts and waits for the
port's own dry run (``ROADMAP.md`` queue A.9.5).
"""
from __future__ import annotations

from typing import Dict

#: name -> (f32 FLOP/s outside the tensor cores, HBM bytes/s)
PEAKS: Dict[str, Dict[str, float]] = {
    "h100_sxm": {"flops": 67e12, "bytes_per_s": 3.35e12},
    "h100_pcie": {"flops": 51e12, "bytes_per_s": 2.0e12},
}


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
