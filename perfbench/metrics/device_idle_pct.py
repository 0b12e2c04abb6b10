"""Device: the share of the traced stretch (its first device operation's
start to its last one's end) in which no operation ran on the device, by
the union of the operations' intervals, in per cent."""


def read(ctx):
    if ctx.trace is None:
        return None
    window = ctx.trace.window_us()
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / window)
