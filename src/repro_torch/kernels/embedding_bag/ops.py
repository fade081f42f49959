"""Public wrapper for the embedding-bag lookup.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel (``csrc/embedding_bag.cu``) or raises — there is
no fallback from the card to the plain version.  The kernel does not
range-check the ids: callers check them once, on the host
(:meth:`repro_torch.models.recsys.WideDeep.rows`).

The kernel has three regimes, which :func:`bag_plan` picks from D, K, the
dtype and the operands' addresses: ``vector`` (lanes over D, 16 bytes a
lane), ``scalar`` (lanes over D, one element a lane) and ``slots`` (lanes
over K, for D ≤ 4).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.common import (
    MAX_INT32,
    LaunchCounter,
    check_cuda_operand,
    check_launch,
    load_library,
    on_cpu,
    stream_handle,
    widest_vector,
)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.obs.profiler import kernel_clock, kernel_time

SOURCE = "embedding_bag.cu"
LAUNCHES = LaunchCounter("embedding_bag")
_STORAGE = (torch.float32, torch.bfloat16)
# widest rows that go to the slots regime (lanes over K)
NARROW_D = 4
# id vectors a lane of the slots regime aims to hold: at K = 40 in 16-byte
# vectors, 4 lanes a bag (2 or 3 vectors each) ran 8 % faster than 2
# lanes of 5 (tools/embedding_bag_variants.py)
SLOT_VECS = 4
_REGIME_CODE = {"vector": 0, "scalar": 0, "slots": 1}


class BagPlan(NamedTuple):
    """How the kernel lays a launch out.

    ``regime``: ``"vector"``, ``"scalar"`` or ``"slots"``; ``vec``:
    elements a lane loads at once, of a table row (``vector``: 16 bytes;
    ``scalar``: 1) or ids of a bag (``slots``: 4 or 1); ``lanes``: threads
    per row group (``vector``/``scalar``) or per bag (``slots``), a power
    of two ≤ 32.
    """

    regime: str
    vec: int
    lanes: int


def _pow2_at_least(n: int, cap: int = 32) -> int:
    p = 1
    while p < min(n, cap):
        p *= 2
    return p


def bag_plan(d: int, k: int, elem: int, *, table_ptr: int, out_ptr: int, ld: int,
             idx_ptr: int, w_ptr: int) -> BagPlan:
    """The regime for a table of D columns of ``elem`` bytes, K slots a bag,
    an output row stride of ``ld`` elements and these addresses (bytes).

    ``vector`` takes rows of D·elem bytes that split into 16-byte chunks,
    a power of two of them or a multiple of 32 (so no lane of a group
    idles), with the table, the output and its row stride all 16-byte
    aligned (:func:`~repro_torch.kernels.common.widest_vector`); other
    rows wider than ``NARROW_D`` take ``scalar``.  ``slots`` loads 4 ids
    and 4 weights at once where K and both addresses allow it, and gives
    a bag the fewest lanes that hold its id vectors in ``SLOT_VECS`` each.
    """
    if d <= NARROW_D:
        kv = 4 if (widest_vector(4, (k,), (idx_ptr,)) == 4
                   and widest_vector(elem, (k,), (w_ptr,)) >= 4) else 1
        return BagPlan("slots", kv, _pow2_at_least(-(-(k // kv) // SLOT_VECS)))
    full = 16 // elem
    chunks = d // full
    if (widest_vector(elem, (d, ld), (table_ptr, out_ptr)) == full
            and ((chunks & (chunks - 1)) == 0 or chunks % 32 == 0)):
        return BagPlan("vector", full, min(chunks, 32))
    return BagPlan("scalar", 1, _pow2_at_least(d))


def launch_plan(table: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                out: torch.Tensor) -> BagPlan:
    """:func:`bag_plan` for these operands (``out`` as the wrapper takes it)."""
    d = table.shape[1]
    return bag_plan(d, idx.shape[1], table.element_size(), table_ptr=table.data_ptr(),
                    out_ptr=out.data_ptr(), ld=out.stride(0) if out.dim() == 3 else d,
                    idx_ptr=idx.data_ptr(), w_ptr=w.data_ptr())


def _out_layout(out: torch.Tensor, b: int, d: int, dev, dtype):
    """``(G, ld)`` of a caller's ``out``: ``(B, D)`` contiguous, or a view of
    shape ``(B/G, G, D)`` with strides ``(ld, D, 1)``, ``ld ≥ G·D``."""
    if out.dim() == 2:
        check_cuda_operand("out", out, device=dev, dtypes=(dtype,), shape=(b, d))
        return 1, d
    if out.device != dev:
        raise ValueError(f"out is on {out.device}, expected {dev}")
    if out.dtype != dtype:
        raise TypeError(f"out has dtype {out.dtype}, expected {dtype}")
    if out.dim() != 3 or out.shape[2] != d or out.shape[0] * out.shape[1] != b:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected (B/G, G, {d}) with B = {b}")
    g, ld = int(out.shape[1]), int(out.stride(0))
    if out.stride(2) != 1 or out.stride(1) != d or ld < g * d:
        raise ValueError(
            f"out has strides {out.stride()}, expected (ld, {d}, 1) with ld >= {g * d}")
    return g, ld


def embedding_bag_op(
    table: torch.Tensor,
    idx: torch.Tensor,
    w: torch.Tensor,
    *,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[b] = Σ_k w[b, k] · table[idx[b, k]]`` in ``table.dtype``.

    ``table`` (V, D) f32 or bf16, ``idx`` (B, K) int32, ``w`` (B, K) of
    the table's dtype.  ``out``, when given, is of the table's dtype and
    either ``(B, D)`` contiguous or a ``(B/G, G, D)`` view with strides
    ``(ld, D, 1)``: bag ``i`` lands at ``out[i // G, i % G]`` (the Wide &
    Deep model's padded MLP input).  Returns ``out``.
    """
    t0 = kernel_clock(table.device)
    if on_cpu(table, idx, w):
        res = embedding_bag_ref(table, idx, w)
        if out is not None:
            out.copy_(res.view(out.shape))
            res = out
        return kernel_time("embedding_bag.ref", t0, res)
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
    g, ld = _out_layout(out, b, d, dev, table.dtype)
    if b == 0 or d == 0:
        return out
    plan = launch_plan(table, idx, w, out)
    fn = load_library(SOURCE).cdll.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    err = fn(
        table.data_ptr(),
        idx.data_ptr(),
        w.data_ptr(),
        out.data_ptr(),
        b,
        k,
        d,
        g,
        ld,
        int(table.dtype == torch.bfloat16),
        _REGIME_CODE[plan.regime],
        plan.vec,
        plan.lanes.bit_length() - 1,
        dev.index,
        stream_handle(dev),
    )
    check_launch("embedding_bag", err)
    LAUNCHES.add()
    return kernel_time("embedding_bag.kernel", t0, out)
