"""Public wrappers for the padded-CSR aggregate and the fused rounds.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the hand-written kernel (``csrc/csr_aggregate.cu``,
``csrc/csr_round_residual.cu``, ``csrc/csr_round.cu``) or raises — there
is no fallback from the card to the plain version.  The wrappers raise
when autograd records an input that requires a gradient
(:func:`~repro_torch.kernels.common.refuse_grad`): only the aggregate has
a backward, through :class:`CSRAggregate`.

**B4's backward is B4.**  ``out = A·F`` over the padded CSR ``A`` (M, D)
has ``∂L/∂F = Aᵀ·∂L/∂out``, the same aggregate over the transposed padded
CSR (:func:`transpose_padded_csr`, built once per graph on the card by a
sort).  :class:`CSRAggregate` launches ``csr_aggregate`` forward on ``A``
and backward on ``Aᵀ``, each launch counted (``AGGREGATE_LAUNCHES``,
``AGGREGATE_BACKWARD_LAUNCHES``); on CPU tensors both directions take the
plain version.  There is no gradient for the operator itself.
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
    refuse_grad,
    stream_handle,
    widest_vector,
)
from repro_torch.kernels.segment_reduce.ref import (
    csr_aggregate_ref,
    csr_round_ref,
    csr_round_residual_ref,
)
from repro_torch.graph.structures import padded_csr_tensors
from repro_torch.obs.profiler import kernel_clock, kernel_time

SOURCE = "csr_round_residual.cu"
LAUNCHES = LaunchCounter("csr_round_residual")
ROUND_SOURCE = "csr_round.cu"
ROUND_LAUNCHES = LaunchCounter("csr_round")
AGGREGATE_SOURCE = "csr_aggregate.cu"
AGGREGATE_LAUNCHES = LaunchCounter("csr_aggregate")
# B4 launched by CSRAggregate.backward on the transposed operator
AGGREGATE_BACKWARD_LAUNCHES = LaunchCounter("csr_aggregate_backward")

# A block walks rows_per_block rows × width live slots per column; aim for
# about this many slots per block so narrow buckets still get long loops
# and wide ones (up to thousands of slots) one row per block.  The round
# kernels give each row of a block to a warp (up to 16 warps a block for
# B1, 8 for B3); on the LP path 1024 and 2048 time alike and 4096 is
# slower (tools/csr_round_variants.py).  The engines may pass another
# ``slots_per_block`` (the autotune sweep's), ``None`` meaning this one.
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


def rows_per_block(width: int, slots_per_block: Optional[int] = None) -> int:
    """Rows one CUDA block covers for a bucket of this many (live) slots a
    row, aiming at ``slots_per_block`` slots a block (default
    ``_SLOTS_PER_BLOCK``)."""
    spb = _SLOTS_PER_BLOCK if slots_per_block is None else int(slots_per_block)
    if spb < 1:
        raise ValueError(f"slots_per_block must be >= 1, got {spb}")
    return max(1, min(_MAX_ROWS_PER_BLOCK, spb // max(1, width)))


def _bucket_rows_per_block(
    m: int, d: int, live: Optional[LiveRows], slots_per_block: Optional[int] = None
) -> int:
    width = d if live is None else cdiv(live.slots, max(1, m))
    return rows_per_block(width, slots_per_block)


def vector_width(F: torch.Tensor) -> int:
    """Columns per lane of the round kernels: the widest access of at most
    16 bytes that F's row length and address keep aligned."""
    return widest_vector(F.element_size(), (F.shape[1],), (F.data_ptr(),))


def aggregate_lanes(s: int, vec: int) -> int:
    """Threads per row group of the aggregate kernel: the power of two that
    covers ``s / vec`` lanes, at most a warp (wider rows take column tiles
    of ``32 * vec``).  At S = 100 in 4-column lanes: 32 (25 of them hold
    columns), one row per warp; at S = 16: 4, eight rows per warp."""
    lanes = 1
    while lanes < 32 and lanes * vec < s:
        lanes *= 2
    return lanes


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
    live: Optional[LiveRows] = None,
) -> torch.Tensor:
    """``out[r] = Σ_k wgt[r, k] · F[nbr[r, k]]`` in ``F.dtype`` (f32 sums).

    The GCN's aggregate over a padded CSR: ``nbr`` (M, D) int32, ``wgt``
    (M, D) and ``F`` (N, S) of one dtype.  Unlike ``repro``'s wrapper
    there is no node-count gate: the kernel gathers F rows from device
    memory, so any N runs on it.  ``out``, when given, is an ``(M, S)``
    buffer of ``F``'s dtype the result is written into.  ``live``, when
    given, lets the kernel stop each row after its live slots plus one
    pad, as in :func:`csr_round_op`; the plain version sums every slot and
    gives the same function.  Raises when autograd records an input that
    requires a gradient: :class:`CSRAggregate` gives F one.
    """
    refuse_grad("csr_aggregate", nbr, wgt, F, hint=", or give F its gradient through "
                "CSRAggregate")
    return _aggregate("csr_aggregate", AGGREGATE_LAUNCHES, nbr, wgt, F, out, live)


def _aggregate(name, counter, nbr, wgt, F, out, live):
    t0 = kernel_clock(F.device)
    if on_cpu(nbr, wgt, F):
        res = csr_aggregate_ref(nbr, wgt, F)
        if out is not None:
            out.copy_(res)
            res = out
        return kernel_time(f"{name}.ref", t0, res)
    m, d, s = _check_bucket(name, nbr, wgt, F)
    dev = F.device
    if out is None:
        out = torch.empty((m, s), dtype=F.dtype, device=dev)
    else:
        check_cuda_operand("out", out, device=dev, dtypes=(F.dtype,), shape=(m, s))
    live_ptr = _check_live(live, m, dev)
    if m == 0 or s == 0:
        return out
    vec = min(vector_width(F), vector_width(out))
    fn = load_library(AGGREGATE_SOURCE).cdll.csr_aggregate_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(
        nbr.data_ptr(),
        wgt.data_ptr(),
        live_ptr,
        F.data_ptr(),
        out.data_ptr(),
        m,
        d,
        s,
        vec,
        aggregate_lanes(s, vec),
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch(name, err)
    counter.add()
    return kernel_time(f"{name}.kernel", t0, out)


class CSRTranspose(NamedTuple):
    """``Aᵀ`` of a padded CSR ``A``: ``(num_cols, D')`` neighbours and
    weights (pads ``(0, 0)`` after each row's live slots) and the rows'
    live lengths."""

    nbr: torch.Tensor
    wgt: torch.Tensor
    live: LiveRows


def transpose_padded_csr(nbr: torch.Tensor, wgt: torch.Tensor, num_cols: int) -> CSRTranspose:
    """The padded CSR of ``Aᵀ`` for ``A[r, nbr[r, k]] += wgt[r, k]``, on
    ``nbr``'s device (a stable sort by column, no host round trip but the
    live-slot total).

    Every slot of nonzero weight becomes one entry ``(nbr[r, k] → r)`` of
    row ``nbr[r, k]``, in row order; zero-weight slots (the pads) add
    nothing to ``Aᵀ·G`` and are dropped, so duplicates stay separate
    entries.  Built once per graph, beside the forward operator."""
    m, d = nbr.shape
    keep = wgt != 0
    rows = torch.arange(m, dtype=torch.int32, device=nbr.device)[:, None].expand(m, d)[keep]
    nbr_t, wgt_t, deg = padded_csr_tensors(rows, nbr[keep], wgt[keep], int(num_cols))
    return CSRTranspose(nbr_t, wgt_t.to(wgt.dtype), LiveRows(deg, int(deg.sum())))


class CSRAggregate(torch.autograd.Function):
    """B4 with a gradient for ``F``: forward ``A·F`` and backward
    ``Aᵀ·∂out`` both on ``csr_aggregate`` (plain versions on the CPU).

    ``apply(F, nbr, wgt, live, transpose)``; ``transpose`` is
    :func:`transpose_padded_csr` of ``(nbr, wgt)``.  No gradient flows to
    the operator: a ``wgt`` that requires one raises."""

    @staticmethod
    def forward(ctx, F, nbr, wgt, live, transpose):
        if wgt.requires_grad or nbr.requires_grad:
            raise ValueError("CSRAggregate: the operator (nbr, wgt) takes no gradient")
        ctx.transpose = transpose
        return _aggregate("csr_aggregate", AGGREGATE_LAUNCHES, nbr, wgt, F, None, live)

    @staticmethod
    def backward(ctx, grad_out):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        t = ctx.transpose
        grad_f = _aggregate("csr_aggregate_backward", AGGREGATE_BACKWARD_LAUNCHES,
                            t.nbr, t.wgt, grad_out.contiguous(), None, t.live)
        return grad_f, None, None, None, None


def csr_round_op(
    nbr: torch.Tensor,
    wgt: torch.Tensor,
    F: torch.Tensor,
    base: torch.Tensor,
    *,
    c: float,
    out: Optional[torch.Tensor] = None,
    live: Optional[LiveRows] = None,
    slots_per_block: Optional[int] = None,
) -> torch.Tensor:
    """Fused ``c·base + A_bucket @ F`` round for one bucket, in ``F.dtype``.

    ``out``, when given, is an ``(M, S)`` buffer of ``F``'s dtype the
    result is written into (the legacy loop passes its slice of the
    bucket-order state).  ``live``, when given, lets the kernel stop each
    row after its live slots (plus one pad, so that a NaN in the F row the
    pads name still reaches the rows that have pads); the plain version
    sums every slot and gives the same function.  ``slots_per_block``
    sizes the kernel's blocks (:func:`rows_per_block`); the plain version
    has none.
    """
    refuse_grad("csr_round", nbr, wgt, F, base)
    t0 = kernel_clock(F.device)
    if on_cpu(nbr, wgt, F, base):
        res = csr_round_ref(nbr, wgt, F, base, c)
        if out is not None:
            out.copy_(res)
            res = out
        return kernel_time("csr_round.ref", t0, res)
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
        _bucket_rows_per_block(m, d, live, slots_per_block),
        vector_width(F),
        float(c),
        int(F.dtype == torch.bfloat16),
        dev.index,
        stream_handle(dev),
    )
    check_launch("csr_round", err)
    ROUND_LAUNCHES.add()
    return kernel_time("csr_round.kernel", t0, out)


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
    slots_per_block: Optional[int] = None,
) -> tuple:
    """Fused superstep for one bucket: round plus max-|out − prev| partial.

    Returns ``(out, delta)``; ``delta`` has one max-partial row per row
    block (``(cdiv(M, rows_per_block(W)), S)`` from the kernel, with ``W``
    the live slots per row rounded up, or ``D`` without ``live``; ``(1, S)``
    from the plain version; ``slots_per_block`` passed on to
    :func:`rows_per_block`) — callers reduce with ``amax(dim=0)`` after
    concatenating buckets.  ``out``, when given, is an ``(M, S)`` f32
    buffer the result is written into (the engine passes its slice of the
    next state, so no per-round concatenation is needed).  ``live`` as for
    :func:`csr_round_op`.
    """
    refuse_grad("csr_round_residual", nbr, wgt, F, base, prev)
    t0 = kernel_clock(F.device)
    if on_cpu(nbr, wgt, F, base, prev):
        res, delta = csr_round_residual_ref(nbr, wgt, F, base, prev, c)
        if out is not None:
            out.copy_(res)
            res = out
        return kernel_time("csr_round_residual.ref", t0, (res, delta))
    m, d, s = _check_bucket("csr_round_residual", nbr, wgt, F, base)
    dev = F.device
    check_cuda_operand("prev", prev, device=dev, dtypes=(torch.float32,), shape=(m, s))
    if out is None:
        out = torch.empty((m, s), dtype=torch.float32, device=dev)
    else:
        check_cuda_operand("out", out, device=dev, dtypes=(torch.float32,), shape=(m, s))
    live_ptr = _check_live(live, m, dev)
    rpb = _bucket_rows_per_block(m, d, live, slots_per_block)
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
    return kernel_time("csr_round_residual.kernel", t0, (out, delta))
