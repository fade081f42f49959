"""rank.extract_ms: host milliseconds a solve in ``extract_outputs`` (the
``lp.extract`` range: the symmetrize of all of F and the copy of every type
block), over the window's solves.  Moves ``solve_s``: the ranking runs
after every solve, on the host, with the card idle."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["lp.extract"], "solve")
