"""Dispatch: the device's operations (kernels, copies, fills) a call, in
the trace of the traced stretch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.traced_calls:
        return None
    return len(ctx.trace.ops) / ctx.traced_calls
