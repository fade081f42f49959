"""solve.halt_wait_ms: host milliseconds a solve blocked in the engine's
``bool(active.any())`` checks (the ``lp.halt`` ranges: the host waits there
for every round queued on the card), over the window's solves.  Moves
``solve_s``."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["lp.halt"], "solve")
