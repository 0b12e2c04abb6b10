"""Dispatch: the device operations a call that the port issues through
PyTorch around its own kernels: the host's enqueue calls (``cudaLaunchKernel*``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``) inside an entry point's span but
outside every ``ka9q.launch.*`` span, over the traced stretch's calls.  None
where the trace has no entry-point span."""

from perfbench import program_spans


def read(ctx):
    if ctx.trace is None or not ctx.traced_calls or not program_spans.entry_spans(ctx.trace):
        return None
    return program_spans.enqueue_split(ctx.trace)[1] / ctx.traced_calls
