"""Kernels: the cell's traceback kernel against the least time of a call's
walk, by the bytes the walk needs (``perfbench/roofline.py``), in per cent
of that bound."""


def read(ctx):
    t = ctx.kernel_s_per_call("walk")
    return None if t is None else 100.0 * ctx.bounds["walk"] / t
