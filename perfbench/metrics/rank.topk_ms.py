"""rank.topk_ms: host milliseconds a solve in ``topk_exclusive`` (the
``lp.topk`` ranges, one per ranked drug), over the window's solves.  Moves
``solve_s``: the ranking runs after every solve, with the card idle."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["lp.topk"], "solve")
