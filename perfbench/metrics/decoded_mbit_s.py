"""End to end: the data bits that the window's calls released, over the
window's whole time (first issue to the last call's output), in Mbit/s."""


def read(ctx):
    return ctx.bits / ctx.window_s / 1e6 if ctx.window_s > 0 else None
