"""Public wrapper for the embedding-bag lookup.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel (``csrc/embedding_bag.cu``) or raises — there is
no fallback from the card to the plain version.  The kernel does not
range-check the ids: callers check them once, on the host
(:meth:`repro_torch.models.recsys.WideDeep.rows`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

SOURCE = "embedding_bag.cu"
LAUNCHES = LaunchCounter("embedding_bag")
_STORAGE = (torch.float32, torch.bfloat16)


def embedding_bag_op(
    table: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    *,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[b] = Σ_k w[b, k] · table[idx[b, k]]`` in ``table.dtype``.

    ``table`` (V, D) f32 or bf16, ``idx`` (B, K) int32, ``w`` (B, K) of
    the table's dtype; ``out``, when given, an ``(B, D)`` buffer of the
    table's dtype.
    """
    if on_cpu(table, idx, w):
        res = embedding_bag_ref(table, idx, w)
        if out is not None:
            out.copy_(res)
            res = out
        return res
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag: unsupported device {dev}")
    v, d = table.shape
    b, k = idx.shape
    check_cuda_operand("table", table, device=dev, dtypes=_STORAGE, shape=(v, d))
    check_cuda_operand("idx", idx, device=dev, dtypes=(torch.int32,), shape=(b, k))
    check_cuda_operand("w", w, device=dev, dtypes=(table.dtype,), shape=(b, k))
    if max(b * k, b * d, v) > MAX_INT32:
        raise ValueError("embedding_bag: operand larger than int32 indexing")
    if out is None:
        out = torch.empty((b, d), dtype=table.dtype, device=dev)
    else:
        check_cuda_operand("out", out, device=dev, dtypes=(table.dtype,), shape=(b, d))
    if b == 0 or d == 0:
        return out
    fn = load_library(SOURCE).cdll.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(
        table.data_ptr(),
        idx.data_ptr(),
        w.data_ptr(),
        out.data_ptr(),
        b,
        k,
        d,
        int(table.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("embedding_bag", err)
    LAUNCHES.add()
    return out
