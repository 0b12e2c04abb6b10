"""Named spans on the profiler's timeline, free when no profiler runs.

``span(name)`` marks a stretch of the host's work.  Under ``torch.profiler``
it is ``torch.profiler.record_function(name)``: the span lands in the same
Chrome trace as the device's operations, as a ``user_annotation`` event on
the profiler's one clock, so the device's idle gaps and the host's enqueue
calls can be put down to it.  With no profiler running it returns one
shared null context after a single flag check, and never enters
``record_function``, which costs microseconds a span even then.

The port's spans, all named ``ka9q.*``:

* ``ka9q.reset``, ``ka9q.update``, ``ka9q.chainback``: ``ViterbiDecoder``'s
  three phases; ``ka9q.push``: ``StreamingDecoder.push``.  These are the
  entry points: a call's host time is the sum of its entry spans.
* ``ka9q.push.walk``, ``ka9q.push.retain``: a release's walk and its copy of
  the retained rows to the front of the window (inside ``ka9q.push``, or in
  ``flush``).
* ``ka9q.alloc``: the growth of the decoder's word buffer or of the
  stream's window, and the words and offset that the depth-4 large-K
  update (``ops.cuda.large_k4.acs_update_large4``) makes in every call.
* ``ka9q.launch.<counter>``: one call of a kernel launcher, named by its key
  in ``ops.cuda._build.LAUNCHES``, so the route a call took is in the trace.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function(name)`` while a profiler runs,
    else the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
