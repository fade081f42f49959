"""Public wrapper for the fused dense LP round.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel ``csrc/lp_round.cu`` or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    MAX_INT32,
    LaunchCounter,
    check_cuda_operand,
    check_launch,
    load_library,
    on_cpu,
    stream_handle,
)
from repro_torch.kernels.lp_blockspmm.ref import lp_round_ref

SOURCE = "lp_round.cu"
LAUNCHES = LaunchCounter("lp_round")
_STORAGE = (torch.float32, torch.bfloat16)


def _launcher():
    fn = load_library(SOURCE).cdll.lp_round_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def lp_round_op(
    A: torch.Tensor, F: torch.Tensor, base: torch.Tensor, *, c: float
) -> torch.Tensor:
    """``c·base + A @ F`` with an f32 accumulator, in ``F.dtype``."""
    if on_cpu(A, F, base):
        return lp_round_ref(A, F, base, c)
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"lp_round: unsupported device {dev}")
    n, s = F.shape
    check_cuda_operand("F", F, device=dev, dtypes=_STORAGE, shape=(n, s))
    check_cuda_operand("A", A, device=dev, dtypes=(F.dtype,), shape=(n, n))
    check_cuda_operand("base", base, device=dev, dtypes=(F.dtype,), shape=(n, s))
    if max(n * n, n * s) > MAX_INT32:
        raise ValueError("lp_round: operand larger than int32 indexing")
    out = torch.empty_like(F)
    if n == 0 or s == 0:
        return out
    err = _launcher()(
        A.data_ptr(),
        F.data_ptr(),
        base.data_ptr(),
        out.data_ptr(),
        n,
        s,
        float(c),
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("lp_round", err)
    LAUNCHES.add()
    return out
