"""Entry points: the host's time a call inside the port's own entry-point
spans (``ka9q.reset`` + ``ka9q.update`` + ``ka9q.chainback``, or
``ka9q.push``), over the traced stretch's calls, in microseconds.  The
in-program counterpart of ``host_issue_us``, read under the profiler, so
larger than the untraced figure.  None where the trace has no such span."""

from perfbench import program_spans


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    entry = program_spans.entry_spans(ctx.trace)
    if not entry:
        return None
    return program_spans.length(entry) / ctx.traced_calls
