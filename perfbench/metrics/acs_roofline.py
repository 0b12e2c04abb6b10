"""Kernels: the cell's ACS kernel (its name pattern in the cell's file)
against the least time of a call's ACS sweep (``perfbench/roofline.py``), in
per cent of that bound: bound / mean device time of the kernel a call."""


def read(ctx):
    t = ctx.kernel_s_per_call("acs")
    return None if t is None else 100.0 * ctx.bounds["acs"] / t
