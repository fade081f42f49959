"""device.idle.bio: the share of the traced window in which no kernel, copy or
set ran on the card, in per cent: 1 − (the union of the device's
intervals) / (the window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.dev_start.size == 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
