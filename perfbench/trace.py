"""Reading a ``torch.profiler`` Chrome trace: the device's operations, its
busy time as the union of their intervals (a copy of the port's
``harness/profiling.device_busy_ms``), the time of kernels by name, and the
gaps in which the device waited, named by what the host was doing then."""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

import torch

__all__ = ["DEVICE_CATS", "Trace", "profile"]

# Kernels, copies and fills: the device's operations.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host events that say what the host was doing.
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Trace:
    """The events of one Chrome trace, split into the device's operations
    and the host's spans (``(start_us, end_us, name)`` each, sorted)."""

    def __init__(self, events: list[dict]):
        def spans(cats):
            return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                          for e in events if e.get("cat") in cats and e.get("ph") == "X")

        self.ops = spans(DEVICE_CATS)
        self.host = spans(HOST_CATS)

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f)["traceEvents"])

    def window_us(self) -> float:
        """From the first device operation's start to the last one's end."""
        if not self.ops:
            return 0.0
        return max(b for _, b, _ in self.ops) - self.ops[0][0]

    def busy_us(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0.0, float("-inf")
        for a, b, _ in self.ops:
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        return busy

    def time_us(self, pattern: str) -> float:
        """Summed duration of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, name in self.ops if rx.search(name))

    def by_name(self) -> list[tuple[str, float]]:
        """Device seconds by operation name, most first."""
        tot: dict[str, float] = {}
        for a, b, name in self.ops:
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])

    def gaps(self, k: int = 10) -> list[tuple[str, float]]:
        """The ``k`` longest intervals in which no device operation ran,
        between the first and the last, as ``(what the host was doing at its
        midpoint, s)``.  The host's innermost span there names it."""
        out, end = [], None
        for a, b, _ in self.ops:
            if end is not None and a > end:
                out.append((end, a))
            end = b if end is None else max(end, b)
        out = sorted(out, key=lambda g: g[0] - g[1])[:k]
        return [(self._host_at((a + b) / 2), (b - a) * 1e-6) for a, b in out]

    def _host_at(self, t: float) -> str:
        """The innermost host span around ``t``; else ``after`` the last one
        that ended before it."""
        inner, before = None, None
        for a, b, name in self.host:
            if a > t:
                break
            if b >= t and (inner is None or b - a <= inner[1] - inner[0]):
                inner = (a, b, name)
            elif b < t and (before is None or b > before[1]):
                before = (a, b, name)
        if inner:
            return inner[2]
        return f"after {before[2]}" if before else "before the first host span"


@contextlib.contextmanager
def profile(result: dict):
    """Trace the device and the host inside the block; on exit
    ``result["trace"]`` holds the ``Trace``.  The Chrome trace is written
    under the temporary directory and removed once read."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        result["trace"] = Trace.from_file(path)
    finally:
        os.remove(path)
