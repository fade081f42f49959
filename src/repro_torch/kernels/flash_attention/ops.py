"""Public wrappers: flash attention, with grouped-query head handling.

A CPU tensor takes the plain version (:func:`.ref.gqa_attention_ref`, the
KV heads repeated to the query heads); a CUDA tensor launches the hand-written kernel
(``csrc/flash_attention.cu``, in the regime :func:`regime` picks: f32 on the
CUDA cores, bf16 prefill or decode on the tensor cores) or raises — there is no fallback from the
card to the plain version, and no size below which the card takes it
(``repro``'s op sends ``Lq·Lk < 128·128`` to its oracle, a cost rule of
Pallas interpret mode).  The kernel reads the KV head ``h // group`` of
query head ``h`` in place: the heads are never repeated in memory.

Two layouts: ``"bhld"`` is ``repro``'s public ``(B, H, L, D)``;
``"blhd"`` is the model's ``(B, L, H, D)`` activations and
``(B, S, H_kv, D)`` cache slices, which the kernel reads through their
strides without a transpose.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import (
    MAX_INT32,
    LaunchCounter,
    cdiv,
    check_launch,
    load_library,
    on_cpu,
    stream_handle,
)
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

SOURCE = "flash_attention.cu"
LAUNCHES = LaunchCounter("flash_attention")
#: head dims the kernel is built for (80: h2o-danube; 16: the REDUCED configs)
HEAD_DIMS = (16, 32, 64, 80, 128)
_STORAGE = (torch.float32, torch.bfloat16)
_VEC = 8  # the kernel reads 8-element vectors: strides and bases aligned to them
_MAX_GRID = 65535  # grid.y (KV heads) and grid.z (batch)
_LAYOUTS = ("bhld", "blhd")
#: the kernel's regimes, numbered as ``flash_attention_launch`` takes them
REGIMES = ("f32", "prefill", "decode")
#: a (batch, KV head) with at most this many rows (positions x group) takes
#: the bf16 decode tile: one 16-row tile, the keys split across its warps
DECODE_ROWS = 16


def regime(dtype: torch.dtype, rows_per_kv_head: int) -> str:
    """The kernel's regime for a launch: ``"f32"`` on the CUDA cores, or in
    bf16 on the tensor cores ``"decode"`` (at most :data:`DECODE_ROWS` rows
    per (batch, KV head), bound by bytes) or ``"prefill"`` (bound by
    operations)."""
    if dtype == torch.float32:
        return "f32"
    return "decode" if rows_per_kv_head <= DECODE_ROWS else "prefill"


def _window_arg(window: Optional[int]) -> int:
    if window is None:
        return 0
    if int(window) < 1:
        raise ValueError(f"window must be a positive number of keys, got {window}")
    return int(window)


def _check_operand(name, t, dev, dtype):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype or dtype not in _STORAGE:
        raise TypeError(f"{name} has dtype {t.dtype}; q, k, v must share one of {_STORAGE}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous")
    if any(s % _VEC for s in t.stride()[:-1]) or t.data_ptr() % (_VEC * t.element_size()):
        raise ValueError(f"{name}: strides and base must be aligned to {_VEC} elements")


def _launch(q, k, v, out, *, causal, window, q_offset):
    """Launch the kernel on sequence-major views; ``out`` like ``q``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_operand(name, t, dev, q.dtype)
    b, lq, hq, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if b > _MAX_GRID or hkv > _MAX_GRID:
        raise ValueError(f"flash_attention: batch {b} or KV heads {hkv} above {_MAX_GRID}")
    if lk > MAX_INT32 or cdiv(lq * group, 16) > MAX_INT32:
        raise ValueError("flash_attention: sequence longer than int32 indexing")
    if not -MAX_INT32 <= q_offset <= MAX_INT32 - lq - 1:
        raise ValueError(f"flash_attention: q_offset {q_offset} outside int32 positions")
    if b == 0 or lq == 0:
        return out
    fn = load_library(SOURCE).cdll.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 3
            + [ctypes.c_float]
            + [ctypes.c_int] * 2
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = fn(
        q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(),
        out.data_ptr(),
        b,
        hkv,
        group,
        lq,
        lk,
        d,
        *strides,
        int(causal),
        window,
        q_offset,
        1.0 / (d**0.5),
        REGIMES.index(regime(q.dtype, lq * group)),
        dev.index,
        stream_handle(dev),
    )
    check_launch("flash_attention", err)
    LAUNCHES.add()
    return out


def gqa_attention_op(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    layout: str = "bhld",
) -> torch.Tensor:
    """Grouped-query attention, out in ``q.dtype``.

    ``layout="bhld"``: q ``(B, Hq, Lq, D)``, k and v ``(B, Hkv, Lk, D)``;
    ``"blhd"``: q ``(B, Lq, Hq, D)``, k and v ``(B, Lk, Hkv, D)``; the
    output has q's layout.  ``Hq`` must be a multiple of ``Hkv``.
    """
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}, got {layout!r}")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q, k, v must be 4-d with k, v alike: {q.shape}, {k.shape}, {v.shape}")
    seq_major = layout == "blhd"
    qs, ks, vs = (t if seq_major else t.transpose(1, 2) for t in (q, k, v))
    b, lq, hq, d = qs.shape
    if ks.shape[0] != b or ks.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree ({layout})")
    hkv = ks.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    win = _window_arg(window)
    q_offset = int(q_offset)
    if on_cpu(q, k, v):
        return gqa_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                 layout=layout)
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if seq_major:
        out = torch.empty((b, lq, hq, d), dtype=q.dtype, device=q.device)
        out_s = out
    else:
        out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
        out_s = out.transpose(1, 2)
    _launch(qs, ks, vs, out_s, causal=causal, window=win, q_offset=q_offset)
    return out


def flash_attention_op(
    q: torch.Tensor,  # (B, H, Lq, D)
    k: torch.Tensor,  # (B, H, Lk, D)
    v: torch.Tensor,  # (B, H, Lk, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``repro``'s ``flash_attention`` signature (its block sizes and
    interpret switch aside): equal query and KV heads, ``(B, H, L, D)``."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] != k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} need equal heads")
    return gqa_attention_op(q, k, v, causal=causal, window=window, q_offset=q_offset)


__all__ = ["DECODE_ROWS", "HEAD_DIMS", "LAUNCHES", "REGIMES", "SOURCE", "flash_attention_op",
           "gqa_attention_op", "regime"]
