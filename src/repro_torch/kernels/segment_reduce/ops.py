"""Public wrappers for the padded-CSR aggregate and the fused rounds.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel (``csrc/csr_aggregate.cu``,
``csrc/csr_round_residual.cu``, ``csrc/csr_round.cu``) or raises — there
is no fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels.common import (
    MAX_INT32,
    LaunchCounter,
    cdiv,
    check_cuda_operand,
    check_launch,
    load_library,
    on_cpu,
    stream_handle,
)
from repro_torch.kernels.segment_reduce.ref import (
    csr_aggregate_ref,
    csr_round_ref,
    csr_round_residual_ref,
)

SOURCE = "csr_round_residual.cu"
LAUNCHES = LaunchCounter("csr_round_residual")
ROUND_SOURCE = "csr_round.cu"
ROUND_LAUNCHES = LaunchCounter("csr_round")
AGGREGATE_SOURCE = "csr_aggregate.cu"
AGGREGATE_LAUNCHES = LaunchCounter("csr_aggregate")

# A block walks rows_per_block rows × width live slots per column; aim for
# about this many slots per block so narrow buckets still get long loops
# and wide ones (up to thousands of slots) one row per block.  The round
# kernels give each row of a block to a warp (up to 16 warps a block for
# B1, 8 for B3); on the LP path 1024 and 2048 time alike and 4096 is
# slower (tools/csr_round_variants.py).
_SLOTS_PER_BLOCK = 2048
_MAX_ROWS_PER_BLOCK = 64
_STORAGE = (torch.float32, torch.bfloat16)


class LiveRows(NamedTuple):
    """Live slots per row of a padded bucket (every pad comes after them).

    ``lengths`` is (M,) int32 on the kernel's device; ``slots`` is its sum,
    kept on the host so that the wrapper sizes the kernel's blocks without
    reading the device.
    """

    lengths: torch.Tensor
    slots: int


def live_rows(wgt: np.ndarray, device) -> LiveRows:
    """Each row's trailing-nonzero count of the host weights ``wgt`` (M, D):
    one past its last nonzero slot, 0 for a row of pads."""
    nz = np.asarray(wgt) != 0
    d = nz.shape[1]
    lengths = np.where(nz.any(axis=1), d - np.argmax(nz[:, ::-1], axis=1), 0)
    return LiveRows(
        torch.as_tensor(lengths.astype(np.int32), device=device), int(lengths.sum())
    )


def rows_per_block(width: int) -> int:
    """Rows one CUDA block covers for a bucket of this many (live) slots a row."""
    return max(1, min(_MAX_ROWS_PER_BLOCK, _SLOTS_PER_BLOCK // max(1, width)))


def _bucket_rows_per_block(m: int, d: int, live: Optional[LiveRows]) -> int:
    return rows_per_block(d if live is None else cdiv(live.slots, max(1, m)))


def vector_width(F: torch.Tensor) -> int:
    """Columns per lane of the round kernels: the widest access of at most
    16 bytes that F's row length and address keep aligned."""
    size = F.element_size()
    vec = 16 // size
    while vec > 1 and (F.shape[1] % vec or F.data_ptr() % (vec * size)):
        vec //= 2
    return vec


def _launcher(source: str, symbol: str, n_pointers: int, n_ints: int):
    fn = getattr(load_library(source).cdll, symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [
            ctypes.c_float,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_live(live: Optional[LiveRows], m: int, dev) -> int:
    """The live-lengths pointer for the kernel (0: every row is full)."""
    if live is None:
        return 0
    check_cuda_operand("live", live.lengths, device=dev, dtypes=(torch.int32,), shape=(m,))
    return live.lengths.data_ptr()


def _check_bucket(name, nbr, wgt, F, base=None):
    """Operand checks shared by the wrappers; returns ``(m, d, s)``."""
    dev = F.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    m, d = nbr.shape
    n, s = F.shape
    check_cuda_operand("nbr", nbr, device=dev, dtypes=(torch.int32,), shape=(m, d))
    check_cuda_operand("wgt", wgt, device=dev, dtypes=(F.dtype,), shape=(m, d))
    check_cuda_operand("F", F, device=dev, dtypes=_STORAGE, shape=(n, s))
    if base is not None:
        check_cuda_operand("base", base, device=dev, dtypes=(torch.float32,), shape=(m, s))
    if max(m * d, n * s, m * s) > MAX_INT32:
        raise ValueError(f"{name}: operand larger than int32 indexing")
    return m, d, s


def csr_aggregate_op(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    F: torch.Tensor,
    *,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``out[r] = Σ_k wgt[r, k] · F[nbr[r, k]]`` in ``F.dtype`` (f32 sums).

    The GCN's aggregate over a padded CSR: ``nbr`` (M, D) int32, ``wgt``
    (M, D) and ``F`` (N, S) of one dtype.  Unlike ``repro``'s wrapper
    there is no node-count gate: the kernel gathers F rows from device
    memory, so any N runs on it.  ``out``, when given, is an ``(M, S)``
    buffer of ``F``'s dtype the result is written into.
    """
    if on_cpu(nbr, wgt, F):
        res = csr_aggregate_ref(nbr, wgt, F)
        if out is not None:
            out.copy_(res)
            res = out
        return res
    m, d, s = _check_bucket("csr_aggregate", nbr, wgt, F)
    dev = F.device
    if out is None:
        out = torch.empty((m, s), dtype=F.dtype, device=dev)
    else:
        check_cuda_operand("out", out, device=dev, dtypes=(F.dtype,), shape=(m, s))
    if m == 0 or s == 0:
        return out
    fn = load_library(AGGREGATE_SOURCE).cdll.csr_aggregate_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(
        nbr.data_ptr(),
        wgt.data_ptr(),
        F.data_ptr(),
        out.data_ptr(),
        m,
        d,
        s,
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("csr_aggregate", err)
    AGGREGATE_LAUNCHES.add()
    return out


def csr_round_op(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    F: torch.Tensor,
    base: torch.Tensor,
    *,
    c: float,
    out: Optional[torch.Tensor] = None,
    live: Optional[LiveRows] = None,
) -> torch.Tensor:
    """Fused ``c·base + A_bucket @ F`` round for one bucket, in ``F.dtype``.

    ``out``, when given, is an ``(M, S)`` buffer of ``F``'s dtype the
    result is written into (the legacy loop passes its slice of the
    bucket-order state).  ``live``, when given, lets the kernel stop each
    row after its live slots (plus one pad, so that a NaN in the F row the
    pads name still reaches the rows that have pads); the plain version
    sums every slot and gives the same function.
    """
    if on_cpu(nbr, wgt, F, base):
        res = csr_round_ref(nbr, wgt, F, base, c)
        if out is not None:
            out.copy_(res)
            res = out
        return res
    m, d, s = _check_bucket("csr_round", nbr, wgt, F, base)
    dev = F.device
    if out is None:
        out = torch.empty((m, s), dtype=F.dtype, device=dev)
    else:
        check_cuda_operand("out", out, device=dev, dtypes=(F.dtype,), shape=(m, s))
    live_ptr = _check_live(live, m, dev)
    if m == 0 or s == 0:
        return out
    err = _launcher(ROUND_SOURCE, "csr_round_launch", 6, 5)(
        nbr.data_ptr(),
        wgt.data_ptr(),
        live_ptr,
        F.data_ptr(),
        base.data_ptr(),
        out.data_ptr(),
        m,
        d,
        s,
        _bucket_rows_per_block(m, d, live),
        vector_width(F),
        float(c),
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("csr_round", err)
    ROUND_LAUNCHES.add()
    return out


def csr_round_residual_op(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    F: torch.Tensor,
    base: torch.Tensor,
    prev: torch.Tensor,
    *,
    c: float,
    out: Optional[torch.Tensor] = None,
    live: Optional[LiveRows] = None,
) -> tuple:
    """Fused superstep for one bucket: round plus max-|out − prev| partial.

    Returns ``(out, delta)``; ``delta`` has one max-partial row per row
    block (``(cdiv(M, rows_per_block(W)), S)`` from the kernel, with ``W``
    the live slots per row rounded up, or ``D`` without ``live``; ``(1, S)``
    from the plain version) — callers reduce with ``amax(dim=0)`` after
    concatenating buckets.  ``out``, when given, is an ``(M, S)`` f32
    buffer the result is written into (the engine passes its slice of the
    next state, so no per-round concatenation is needed).  ``live`` as for
    :func:`csr_round_op`.
    """
    if on_cpu(nbr, wgt, F, base, prev):
        res, delta = csr_round_residual_ref(nbr, wgt, F, base, prev, c)
        if out is not None:
            out.copy_(res)
            res = out
        return res, delta
    m, d, s = _check_bucket("csr_round_residual", nbr, wgt, F, base)
    dev = F.device
    check_cuda_operand("prev", prev, device=dev, dtypes=(torch.float32,), shape=(m, s))
    if out is None:
        out = torch.empty((m, s), dtype=torch.float32, device=dev)
    else:
        check_cuda_operand("out", out, device=dev, dtypes=(torch.float32,), shape=(m, s))
    live_ptr = _check_live(live, m, dev)
    rpb = _bucket_rows_per_block(m, d, live)
    delta = torch.empty((cdiv(m, rpb), s), dtype=torch.float32, device=dev)
    if m == 0 or s == 0:
        return out, delta
    err = _launcher(SOURCE, "csr_round_residual_launch", 8, 5)(
        nbr.data_ptr(),
        wgt.data_ptr(),
        live_ptr,
        F.data_ptr(),
        base.data_ptr(),
        prev.data_ptr(),
        out.data_ptr(),
        delta.data_ptr(),
        m,
        d,
        s,
        rpb,
        vector_width(F),
        float(c),
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("csr_round_residual", err)
    LAUNCHES.add()
    return out, delta
