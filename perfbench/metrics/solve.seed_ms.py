"""solve.seed_ms: host milliseconds a solve building the seed matrix Y
(``lp.seeds``: ``seeds_identity``, float64) and sending it to the card
(``lp.upload``: the float32 copy and the pageable host-to-device copy), over
the window's solves.  Moves ``solve_s``."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["lp.seeds", "lp.upload"], "solve")
