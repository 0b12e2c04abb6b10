"""Device: of the device's idle time in the traced stretch (the gaps between
the union of its operations, first to last, as ``device_idle_pct`` takes
it), the per cent during which the host was inside one of the port's
entry-point spans.  The rest is idle time the caller caused.  None where the
stretch has no idle time or no such span."""

from perfbench import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    entry = program_spans.entry_spans(ctx.trace)
    idle = program_spans.idle_intervals(ctx.trace)
    total = program_spans.length(idle)
    if not entry or total <= 0:
        return None
    return 100.0 * program_spans.overlap(idle, entry) / total
