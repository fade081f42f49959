"""The program's own ranges in a traced window, for the per-layer readers.

The program opens ``_RecordFunctionFast`` ranges inside its host loops
(``repro_torch.obs.profiler.hot_span``): ``lp.*`` in the engines and the
ranking, ``bio.*`` in the ``dhlp-bio`` plan build.  They are plain CPU
events of the trace (``Trace.host_name`` / ``host_start`` /
``host_end``), on the clock of the device's kernels.  A program without
them (an older one) leaves every reading here ``None``.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from perfbench.harness.trace import Trace

#: name prefixes of the program's ranges
PREFIXES = ("lp.", "bio.")

#: the trace last indexed (held weakly: a trace is large) and its index
_last = {"trace": lambda: None, "index": None}


def ranges(tr: Trace) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """The program's ranges by name, clipped to the window: name ->
    (starts, ends), each sorted by start.  Built once per trace."""
    if _last["trace"]() is tr:
        return _last["index"]
    lo, hi = tr.window
    found: Dict[str, list] = {}
    for i, name in enumerate(tr.host_name):
        if name.startswith(PREFIXES):
            found.setdefault(name, []).append(i)
    out = {}
    for name, idx in found.items():
        idx = np.asarray(idx)
        s = np.clip(tr.host_start[idx], lo, hi)
        e = np.clip(tr.host_end[idx], lo, hi)
        order = np.argsort(s, kind="stable")
        out[name] = (s[order], e[order])
    _last.update(trace=weakref.ref(tr), index=out)
    return out


def ms_per_call(tr: Optional[Trace], names: Sequence[str], per: str) -> Optional[float]:
    """Milliseconds of the ``names`` ranges inside the window, over the
    count of the benchmark's ``per`` ranges (a solve or a step).  ``None``
    when none of ``names`` is in the trace or no ``per`` range is."""
    if tr is None or tr.span_count(per) == 0:
        return None
    idx = ranges(tr)
    have = [idx[n] for n in names if n in idx]
    if not have:
        return None
    total = sum(int((e - s).sum()) for s, e in have)
    return total / 1e6 / tr.span_count(per)


def _union(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint, sorted blocks covering the given intervals."""
    keep = ends > starts
    s, e = starts[keep], ends[keep]
    if s.size == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    run = np.maximum.accumulate(e)
    new = s[1:] > run[:-1]
    return (np.concatenate([s[:1], s[1:][new]]), np.concatenate([run[:-1][new], run[-1:]]))


def _covered(blocks: Tuple[np.ndarray, np.ndarray], s: np.ndarray, e: np.ndarray) -> int:
    """Total length of the disjoint sorted ``blocks`` inside the intervals
    ``[s, e)`` (themselves disjoint)."""
    bs, be = blocks
    if bs.size == 0 or s.size == 0:
        return 0
    cum = np.concatenate([[0], np.cumsum(be - bs)])

    def upto(t):  # length of the blocks before time t
        k = np.searchsorted(bs, t, side="right")
        last = np.maximum(k - 1, 0)
        return np.where(k > 0, cum[last] + np.minimum(t, be[last]) - bs[last], 0)

    return int((upto(e) - upto(s)).sum())


def named_idle_share(tr: Optional[Trace]) -> Optional[float]:
    """Of the window's device-idle time, the per cent that lies inside some
    program range.  ``None`` with no device events, no idle time, or no
    program range in the window."""
    if tr is None or tr.dev_start.size == 0:
        return None
    idx = ranges(tr)
    if not idx:
        return None
    lo, hi = tr.window
    starts, ends = tr.busy_blocks()
    gap_s = np.concatenate([[lo], ends])
    gap_e = np.concatenate([starts, [hi]])
    idle = int(np.maximum(gap_e - gap_s, 0).sum())
    if idle <= 0:
        return None
    program = _union(np.concatenate([s for s, _ in idx.values()]),
                     np.concatenate([e for _, e in idx.values()]))
    keep = gap_e > gap_s
    return 100.0 * _covered(program, gap_s[keep], gap_e[keep]) / idle
