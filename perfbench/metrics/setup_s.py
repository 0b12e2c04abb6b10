"""End to end: process start to the end of warm-up (imports, the device's
context, the kernels loaded or built, the inputs made, the warm-up calls),
in seconds."""


def read(ctx):
    return ctx.setup_s
