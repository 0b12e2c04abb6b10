"""Profiling and tracing utilities.

Port of ``ka9q_viterbi_comparison_tpu/harness/profiling.py``.  The
reference's observability is a chrono Timer and raw per-iteration ns samples
(ref: src/timer.h:6-21, src/main.cpp:99-108).  On the card the equivalents
are CUDA-event spans around the phases (``harness.bench``) plus
``torch.profiler`` traces; this module wraps the profiler so that a benchmark
run can drop a Chrome trace next to its JSON samples.  The port's own named
spans, which land in that trace, are ``utils.spans``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["device_trace", "device_busy_ms", "sharded_phase_spans"]


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


def device_busy_ms(log_dir: str) -> float:
    """The device's busy time in the trace ``device_trace`` wrote to
    ``log_dir``, ms: the union of its kernels', copies' and fills' intervals
    over every stream (a sum of ``key_averages()``' device times counts
    a collective twice, as its kernel and its annotation, and overlapping
    streams once each)."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


@contextlib.contextmanager
def sharded_phase_spans():
    """CUDA events around every ``_sharded_acs_scan`` and
    ``_sharded_traceback`` call inside the block (``parallel/statewise.py``,
    and ``parallel/state_time.py``, which imports both): yields ``{"scan":
    [...], "traceback": [...], "host_s": {"scan": [...], "traceback":
    [...]}}``, (start, end) event pairs to read after a synchronise with
    ``elapsed_time``, and the host clock's seconds of each call (its issue:
    the calls wait for no device work)."""
    from ..parallel import state_time, statewise

    spans = {"scan": [], "traceback": [], "host_s": {"scan": [], "traceback": []}}
    saved = []
    for mod in (statewise, state_time):
        for name, key in (("_sharded_acs_scan", "scan"), ("_sharded_traceback", "traceback")):
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def timed(*args, fn=fn, key=key):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                t0 = time.perf_counter()
                out = fn(*args)
                spans["host_s"][key].append(time.perf_counter() - t0)
                end.record()
                spans[key].append((start, end))
                return out

            setattr(mod, name, timed)
    try:
        yield spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

