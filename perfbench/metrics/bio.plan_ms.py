"""bio.plan_ms: host milliseconds a step in ``dhlp_bio.lp_plan`` (the
``bio.plan`` range: the edges to the host, the blocked-CSR bucketing, the
buckets to the card), over the window's steps.  Moves ``bio_step_s``: the
plan is rebuilt every step, the card idle for most of it."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["bio.plan"], "step")
