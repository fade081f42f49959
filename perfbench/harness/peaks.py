"""Published peaks of the cards the benchmark reads a roofline on.

Frozen copy of ``repro_torch.bench.roofline.PEAKS`` and its name rule
(``peak_model``) as at commit ca3ff8b: NVIDIA's H100 data sheet, dense
rates without sparsity, at the full power limit.  The LP rounds run on the
CUDA cores in float32, so the float32 rate (an FMA counted as two
operations) and the HBM bandwidth are the two that bound them.
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    "h100_sxm": {"flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12,
                 "hbm_bytes": 80e9, "link_bytes_per_s": 450e9},
    "h100_pcie": {"flops": 51e12, "bf16_flops": 756e12, "bytes_per_s": 2.0e12,
                  "hbm_bytes": 80e9, "link_bytes_per_s": 64e9},
}


def peak_model(device_name: str) -> Optional[str]:
    """The :data:`PEAKS` key for a card's name; ``None`` for any other card."""
    name = device_name.upper()
    if "H100" in name and "PCIE" in name:
        return "h100_pcie"
    if "H100" in name and ("SXM" in name or "HBM3" in name):
        return "h100_sxm"
    return None


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    model = peak_model(device_name)
    return None if model is None else PEAKS[model]
