"""solve.download_ms: host milliseconds a solve bringing F back
(``lp.download``: ``to_numpy_f64``'s pinned buffer, the device-to-host copy,
the widening to float64, and the per-column round counts), over the
window's solves.  Moves ``solve_s``."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["lp.download"], "solve")
