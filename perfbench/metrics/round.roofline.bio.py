"""round.roofline.bio: the least time of the window's dhlp-bio rounds on the
card over the device kernel time inside the steps, in per cent.

Each step is ``rounds`` rounds F = β²·Y + W·F over all S seed columns, N
rows and the operator's nonzeros, each input byte once
(``perfbench/harness/roofline.py``); the kernel time is that of every
kernel that starts inside a ``step`` range, the plan's included.  Moves
``bio_step_s``."""

from perfbench.harness import roofline


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or ctx.peaks is None or "bio.steps" not in c:
        return None
    kernel_s = ctx.trace.kernel_seconds_in("step")
    if kernel_s <= 0:
        return None
    cost = roofline.lp_round(n=c["bio.n"], nnz=c["bio.nnz"], s=c["bio.s"], residual=False,
                             base_is_f=False)
    least = roofline.least_seconds(cost, ctx.peaks)["seconds"] * c["bio.rounds"]
    return 100.0 * least * ctx.trace.span_count("step") / kernel_s
