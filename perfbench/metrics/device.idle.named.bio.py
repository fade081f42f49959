"""device.idle.named.bio: of the traced window's device-idle time (no
kernel, copy or set on the card), the per cent that lies inside some range
of the program (``lp.*``, ``bio.*``).  Moves ``bio_step_s``: what this
share leaves out is idle time no program range can name."""

from perfbench.harness import spans


def read(ctx):
    return spans.named_idle_share(ctx.trace)
