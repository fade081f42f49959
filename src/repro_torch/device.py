"""Device policy: the port runs on the card unless told otherwise.

There is no silent CPU fallback.  ``device=None`` means ``cuda:0`` and
raises when CUDA is missing; the CPU is used only when the caller asks
for it (the tests do, with ``device="cpu"``).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the device an entry point runs on.

    ``None`` -> ``cuda:0``; ``"cpu"`` -> the CPU; ``"cuda"``/``"cuda:k"``
    -> that card.  Any CUDA request without CUDA raises ``RuntimeError``.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the "
                "CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_numpy_f64(t: torch.Tensor) -> np.ndarray:
    """A tensor as a new float64 numpy array (the solvers' result type).

    From the card, the tensor travels in its own 32-bit type (half the
    bytes of float64) into pinned host memory, and is widened on the host.
    """
    if t.dtype not in (torch.float32, torch.float64):
        t = t.float()
    if t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    return t.numpy().astype(np.float64)


__all__ = ["DeviceLike", "resolve_device", "to_numpy_f64"]
