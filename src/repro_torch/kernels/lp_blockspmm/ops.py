"""Public wrapper for the fused dense LP round.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel ``csrc/lp_round.cu`` or raises.  The kernel runs
on the tensor cores in TF32: f32 storage as three products of split
operands (``3xtf32``, f32-accurate), bf16 storage as one (its values are
exact in TF32).  Its pre-pass writes ``F`` transposed and split into
scratch the wrapper allocates per call (and an f32 copy of ``A`` when TMA
cannot read ``A`` in place).
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
    refuse_grad,
    round_up,
    stream_handle,
)
from repro_torch.kernels.lp_blockspmm.ref import lp_round_ref
from repro_torch.obs.profiler import kernel_clock, kernel_time

SOURCE = "lp_round.cu"
LAUNCHES = LaunchCounter("lp_round")
_STORAGE = (torch.float32, torch.bfloat16)


def regime(dtype: torch.dtype) -> str:
    """The kernel's product for a storage dtype: ``"3xtf32"`` (f32: hi·hi +
    hi·lo + lo·hi of TF32 terms) or ``"1xtf32"`` (bf16: hi·hi alone)."""
    return "1xtf32" if dtype == torch.bfloat16 else "3xtf32"


def _launcher():
    fn = load_library(SOURCE).cdll.lp_round_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [
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
    refuse_grad("lp_round", A, F, base)
    t0 = kernel_clock(F.device)
    if on_cpu(A, F, base):
        return kernel_time("lp_round.ref", t0, lp_round_ref(A, F, base, c))
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"lp_round: unsupported device {dev}")
    n, s = F.shape
    check_cuda_operand("F", F, device=dev, dtypes=_STORAGE, shape=(n, s))
    check_cuda_operand("A", A, device=dev, dtypes=(F.dtype,), shape=(n, n))
    check_cuda_operand("base", base, device=dev, dtypes=(F.dtype,), shape=(n, s))
    n4 = round_up(n, 4)  # TMA rows are multiples of 16 bytes
    if max(n * n4, n * s, s * n4) > MAX_INT32:
        raise ValueError("lp_round: operand larger than int32 indexing")
    out = torch.empty_like(F)
    if n == 0 or s == 0:
        return out
    three = regime(F.dtype) == "3xtf32"
    # F^T as TF32 terms: hi, and lo for 3xtf32
    ft = torch.empty((2 if three else 1, s, n4), dtype=torch.float32, device=dev)
    a_pad = None
    if not three or n % 4 or A.data_ptr() % 16:
        a_pad = torch.empty((n, n4), dtype=torch.float32, device=dev)
    err = _launcher()(
        A.data_ptr(),
        F.data_ptr(),
        base.data_ptr(),
        out.data_ptr(),
        ft[0].data_ptr(),
        ft[1].data_ptr() if three else None,
        None if a_pad is None else a_pad.data_ptr(),
        n,
        s,
        float(c),
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("lp_round", err)
    LAUNCHES.add()
    return kernel_time("lp_round.kernel", t0, out)
