"""Entry points: the host's time to issue one call (the benchmark's own
clock around the call, without the wait for its output), mean over the
window's calls outside the traced stretch, in microseconds."""


def read(ctx):
    if not ctx.issue_s:
        return None
    return sum(ctx.issue_s) / len(ctx.issue_s) * 1e6
