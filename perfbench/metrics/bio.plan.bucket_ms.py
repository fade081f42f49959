"""bio.plan.bucket_ms: host milliseconds a step in ``BlockedCSR.from_edges``
(the ``bio.plan.bucket`` range inside ``lp_plan``: numpy sorts and scatters
of the 20 M edges), over the window's steps.  Moves ``bio_step_s``."""

from perfbench.harness import spans


def read(ctx):
    return spans.ms_per_call(ctx.trace, ["bio.plan.bucket"], "step")
