"""The traced window: ``torch.profiler`` over it, read into a few arrays.

The profiler keeps its events in memory; nothing is written to disk.  The
benchmark marks the window and its calls into the program with
``record_function`` ranges (``window``, ``solve``, ``rank``, ``step``),
and a traffic kind loaded from a file may name more (its ``RANGES``); the
device's kernels, copies and sets are read from the same trace, on the
same clock.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


#: the ranges the benchmark opens; the profiler also reports each of them as
#: a device-side annotation, which is no device work
SPANS = ("window", "solve", "rank", "step")


class Tracer:
    """``span(name)`` marks a call; a no-op when the run is not traced.
    ``ranges``: the names the cell's kind opens besides ``SPANS``."""

    def __init__(self, enabled: bool, ranges: Sequence[str] = ()):
        self.enabled = enabled
        self.ranges = SPANS + tuple(r for r in ranges if r not in SPANS)
        self.prof = None

    def span(self, name: str):
        if name not in self.ranges:
            raise ValueError(f"unknown range {name!r}; this cell's are {self.ranges}")
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self, ready=None):
        """The window, traced when enabled; ``ready()`` runs once the
        profiler records, before the window's range opens (the ranks of a
        cell meet there, so their windows open together)."""
        if not self.enabled:
            yield
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        with self.prof:
            if ready is not None:
                ready()
            with torch.profiler.record_function("window"):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()


@dataclasses.dataclass
class Trace:
    """Events of a traced window, times in ns on the profiler's clock."""

    dev_name: List[str]
    dev_kind: np.ndarray  # "kernel" | "memcpy" | "memset"
    dev_start: np.ndarray
    dev_end: np.ndarray
    spans: Dict[str, Tuple[np.ndarray, np.ndarray]]  # name -> (starts, ends), sorted
    host_name: List[str]
    host_start: np.ndarray
    host_end: np.ndarray
    window: Tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_blocks(self) -> Tuple[np.ndarray, np.ndarray]:
        """The union of device intervals inside the window, as blocks."""
        lo, hi = self.window
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if s.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        run = np.maximum.accumulate(e)
        new = s[1:] > run[:-1]
        starts = np.concatenate([s[:1], s[1:][new]])
        ends = np.concatenate([run[:-1][new], run[-1:]])
        return starts, ends

    @property
    def busy_s(self) -> float:
        starts, ends = self.busy_blocks()
        return float((ends - starts).sum()) / 1e9

    def kernel_seconds_in(self, span: str) -> float:
        """Device kernel time of kernels that start inside ``span`` ranges."""
        if span not in self.spans:
            return 0.0
        ss, se = self.spans[span]
        k = self.dev_kind == "kernel"
        ks, ke = self.dev_start[k], self.dev_end[k]
        idx = np.searchsorted(ss, ks, side="right") - 1
        inside = (idx >= 0) & (ks < se[np.maximum(idx, 0)])
        return float((ke[inside] - ks[inside]).sum()) / 1e9

    def span_count(self, span: str) -> int:
        return int(self.spans[span][0].size) if span in self.spans else 0

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event around their middle."""
        tot: Dict[str, float] = {}
        for name, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e9
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        starts, ends = self.busy_blocks()
        lo, hi = self.window
        g_start = np.concatenate([[lo], ends])
        g_end = np.concatenate([starts, [hi]])
        length = g_end - g_start
        gaps = []
        for i in np.argsort(-length, kind="stable")[:top]:
            if length[i] <= 0:
                break
            mid = (g_start[i] + g_end[i]) // 2
            around = (self.host_start <= mid) & (self.host_end >= mid)
            if around.any():
                dur = np.where(around, self.host_end - self.host_start, np.iinfo(np.int64).max)
                name = self.host_name[int(np.argmin(dur))]
            else:
                name = "host: no traced event"
            gaps.append([name, float(length[i]) / 1e9])
        return {"device_ops": [[n, float(v)] for n, v in ops], "idle_gaps": gaps}


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def read(prof, ranges: Sequence[str] = SPANS) -> Trace:
    """Read a finished ``torch.profiler.profile`` into a :class:`Trace`;
    ``ranges`` are the benchmark's range names (a ``Tracer``'s)."""
    dn: List[str] = []
    dk: List[str] = []
    ds: List[int] = []
    de: List[int] = []
    spans: Dict[str, List[Tuple[int, int]]] = {}
    hn: List[str] = []
    hs: List[int] = []
    he: List[int] = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            # a host range mirrored on the device (the benchmark's, a kind's,
            # "nccl:all_reduce") is no device work
            if not ev.is_user_annotation():
                dn.append(name)
                dk.append(_device_kind(name))
                ds.append(start)
                de.append(end)
            continue
        if name in ranges:
            spans.setdefault(name, []).append((start, end))
        hn.append(name)
        hs.append(start)
        he.append(end)
    if "window" not in spans:
        raise RuntimeError("the trace holds no 'window' range")
    sp = {}
    for name, ivs in spans.items():
        ivs.sort()
        arr = np.asarray(ivs, dtype=np.int64)
        sp[name] = (arr[:, 0], arr[:, 1])
    w = sp["window"]
    return Trace(
        dev_name=dn,
        dev_kind=np.asarray(dk, dtype="U8"),
        dev_start=np.asarray(ds, dtype=np.int64),
        dev_end=np.asarray(de, dtype=np.int64),
        spans=sp,
        host_name=hn,
        host_start=np.asarray(hs, dtype=np.int64),
        host_end=np.asarray(he, dtype=np.int64),
        window=(int(w[0][0]), int(w[1][0])),
    )
