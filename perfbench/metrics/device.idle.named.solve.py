"""device.idle.named.solve: of the traced window's device-idle time (no
kernel, copy or set on the card), the per cent that lies inside some range
of the program (``lp.*``, ``bio.*``).  Moves ``solve_s``: what this share
leaves out is idle time no program range can name (the harness's own host
work, the gaps between ranges)."""

from perfbench.harness import spans


def read(ctx):
    return spans.named_idle_share(ctx.trace)
