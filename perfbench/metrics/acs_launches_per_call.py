"""Dispatch: the device operations a call that the port's ACS launchers
enqueue: the host's enqueue calls (``cudaLaunchKernel*``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``) inside an entry point's span and a
``ka9q.launch.acs_update*`` span, placed as ``program_spans.enqueue_split``
places them, over the traced stretch's calls.  One where a call's ACS sweep
is one launch; the depth-4 large-K route's plan (the entry minimum, the
octets, the 7-step launch, the last shift) is many.  None where the trace
has no such span."""

import types

from perfbench import program_spans

PREFIX = program_spans.LAUNCH + "acs_update"


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls:
        return None
    # The trace's host events without the spans of the other launchers.
    host = [e for e in ctx.trace.host
            if not e[2].startswith(program_spans.LAUNCH) or e[2].startswith(PREFIX)]
    if not any(name.startswith(PREFIX) for _, _, name in host):
        return None
    return program_spans.enqueue_split(types.SimpleNamespace(host=host))[0] / ctx.traced_calls
