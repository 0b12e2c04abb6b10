"""Profiling and tracing utilities.

Port of ``ka9q_viterbi_comparison_tpu/harness/profiling.py``.  The
reference's observability is a chrono Timer and raw per-iteration ns samples
(ref: src/timer.h:6-21, src/main.cpp:99-108).  On the card the equivalents
are CUDA-event spans around the phases (``harness.bench``) plus
``torch.profiler`` traces; this module wraps the profiler so that a benchmark
run can drop a Chrome trace next to its JSON samples.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["device_trace", "Timer", "annotate", "sharded_phase_spans"]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a host and device trace of the enclosed block and write it to
    ``log_dir/trace.json`` (Chrome trace format: ``chrome://tracing`` or
    Perfetto).  Yields the profiler, whose ``key_averages()`` sums the time
    by kernel name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def sharded_phase_spans():
    """CUDA events around every ``_sharded_acs_scan`` and
    ``_sharded_traceback`` call inside the block (``parallel/statewise.py``,
    and ``parallel/state_time.py``, which imports both): yields ``{"scan":
    [...], "traceback": [...]}`` of (start, end) event pairs, read after a
    synchronise with ``elapsed_time``."""
    from ..parallel import state_time, statewise

    spans = {"scan": [], "traceback": []}
    saved = []
    for mod in (statewise, state_time):
        for name, key in (("_sharded_acs_scan", "scan"), ("_sharded_traceback", "traceback")):
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def timed(*args, fn=fn, key=key):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                out = fn(*args)
                end.record()
                spans[key].append((start, end))
                return out

            setattr(mod, name, timed)
    try:
        yield spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def annotate(name: str):
    """Named span that shows up on the trace's timeline."""
    return torch.profiler.record_function(name)


class Timer:
    """Monotonic ns timer with the reference Timer's get_delta contract
    (ref: src/timer.h:15-20): construction starts it, get_delta returns the
    elapsed span."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter_ns()

    def get_delta_ns(self) -> int:
        return time.perf_counter_ns() - self._t0

    def get_delta_s(self) -> float:
        return self.get_delta_ns() * 1e-9
