"""The port's own spans in a trace: the ``ka9q.*`` user annotations that the
program records under the profiler (its ``utils/spans.py``), on the same
clock as the device's operations and the host's CUDA runtime calls.

The entry points' spans (``ka9q.reset``, ``ka9q.update``,
``ka9q.chainback``, ``ka9q.push``) hold a call's host work; a kernel
launcher's call is a ``ka9q.launch.<counter>`` span inside one.  The host's
enqueue calls (``cudaLaunchKernel*``, ``cudaMemcpyAsync``,
``cudaMemsetAsync``) each put one operation on the device.  A trace of a
program without these spans has none of them, and the readers built on this
module then find nothing."""

from __future__ import annotations

import bisect

__all__ = ["ENTRY", "LAUNCH", "ENQUEUE", "union", "length", "overlap", "entry_spans",
           "enqueue_split", "idle_intervals"]

ENTRY = frozenset({"ka9q.reset", "ka9q.update", "ka9q.chainback", "ka9q.push"})
LAUNCH = "ka9q.launch."
ENQUEUE = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def union(intervals) -> list[tuple[float, float]]:
    """The sorted, disjoint union of ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(merged) -> float:
    return sum(b - a for a, b in merged)


def overlap(x, y) -> float:
    """The length of the intersection of two disjoint, sorted unions."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        total += max(0.0, min(x[i][1], y[j][1]) - max(x[i][0], y[j][0]))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def _inside(t: float, merged, starts) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= merged[k][1]


def entry_spans(trace) -> list[tuple[float, float]]:
    """The union of the entry points' spans (they do not nest, so its
    length is their summed duration)."""
    return union((a, b) for a, b, name in trace.host if name in ENTRY)


def enqueue_split(trace) -> tuple[int, int]:
    """The host's enqueue calls inside an entry point's span: ``(inside a
    launcher's span, outside every launcher's span)``.  A call is placed by
    its midpoint."""
    entry = entry_spans(trace)
    launch = union((a, b) for a, b, name in trace.host if name.startswith(LAUNCH))
    e_starts, l_starts = [a for a, _ in entry], [a for a, _ in launch]
    inside = outside = 0
    for a, b, name in trace.host:
        if not name.startswith(ENQUEUE):
            continue
        t = (a + b) / 2
        if _inside(t, entry, e_starts):
            if _inside(t, launch, l_starts):
                inside += 1
            else:
                outside += 1
    return inside, outside


def idle_intervals(trace) -> list[tuple[float, float]]:
    """The gaps between the union of the device's operations, from the
    first one's start to the last one's end."""
    busy = union((a, b) for a, b, _ in trace.ops)
    return [(busy[k][1], busy[k + 1][0]) for k in range(len(busy) - 1)]
