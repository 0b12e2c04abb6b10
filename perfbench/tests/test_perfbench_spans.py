"""The readers of the port's own spans (``program_issue_us``,
``glue_ops_per_call``, ``idle_in_program_pct``) on a small synthetic Chrome
trace of two frame calls, each against its value worked by hand; none of
them finds anything without a trace or in a trace without the port's spans
(a program that records none)."""

import pytest

from perfbench import program_spans, spec
from perfbench.cell import Context
from perfbench.trace import Trace
from perfbench.tests import small

READERS = ("program_issue_us", "glue_ops_per_call", "idle_in_program_pct")


def _event(cat, name, ts, end):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts}


def _span(name, ts, end):
    return _event("user_annotation", name, ts, end)


def _runtime(name, ts, end):
    return _event("cuda_runtime", name, ts, end)


PORT_SPANS = [
    # Call 1: reset, update (its launch), chainback (its launch), us.
    _span("ka9q.reset", 0, 10),
    _span("ka9q.update", 10, 40),
    _span("ka9q.alloc", 11, 12),
    _span("ka9q.launch.acs_update_inplace", 20, 30),
    _span("ka9q.chainback", 40, 60),
    _span("ka9q.launch.chainback_inplace", 45, 55),
    # Call 2.
    _span("ka9q.reset", 100, 105),
    _span("ka9q.update", 105, 120),
    _span("ka9q.launch.acs_update_inplace", 108, 118),
    _span("ka9q.chainback", 120, 130),
    _span("ka9q.launch.chainback_inplace", 122, 128),
]

OTHER = [
    # Enqueue calls: four inside the launchers' spans, three outside them
    # inside an entry span (the glue), one outside every span (the caller's).
    _runtime("cudaLaunchKernel", 22, 24),
    _runtime("cudaLaunchKernelExC", 46, 48),
    _runtime("cudaLaunchKernel", 110, 111),
    _runtime("cudaLaunchKernel", 123, 124),
    _runtime("cudaMemsetAsync", 12.5, 13),
    _runtime("cudaLaunchKernel", 42, 43),
    _runtime("cudaLaunchKernel", 101, 102),
    _runtime("cudaMemcpyAsync", 70, 71),
    # Not enqueue calls.
    _runtime("cudaEventRecord", 61, 62),
    _runtime("cudaStreamIsCapturing", 41, 41.5),
    _event("cpu_op", "aten::empty", 11, 11.5),
    # The device: 7 operations, idle 15-25, 84-90, 95-103, 104-112, 150-160.
    _event("gpu_memset", "Memset (Device)", 13, 15),
    _event("kernel", "acs", 25, 80),
    _event("kernel", "gather", 80, 84),
    _event("kernel", "walk", 90, 95),
    _event("kernel", "fill", 103, 104),
    _event("kernel", "acs", 112, 150),
    _event("kernel", "walk", 160, 170),
]


def _ctx(events, traced_calls=2):
    s = small.cell_spec(small.config("viterbi27"), small.frames())
    return Context(s, trace=Trace(events), traced_calls=traced_calls)


def test_readers_give_the_hand_worked_values():
    ctx = _ctx(PORT_SPANS + OTHER)
    read = {name: spec.reader(name)(ctx) for name in READERS + ("device_ops_per_call",)}
    # Entry spans 0-60 and 100-130: 90 us over 2 calls.
    assert read["program_issue_us"] == pytest.approx(45.0)
    # The memset at 12.5, the kernels at 42 and 101: 3 over 2 calls.
    assert read["glue_ops_per_call"] == pytest.approx(1.5)
    # Idle 10 + 6 + 8 + 8 + 10 = 42 us; inside entry spans 10 (15-25), 3 (100-103),
    # 8 (104-112): 21 of 42.
    assert read["idle_in_program_pct"] == pytest.approx(50.0)
    # Every device operation is accounted for: the glue and the launchers' enqueues.
    inside, outside = program_spans.enqueue_split(ctx.trace)
    assert (inside, outside) == (4, 3)
    assert (inside + outside) / 2 == read["device_ops_per_call"]


def test_readers_find_nothing_without_a_trace():
    s = small.cell_spec(small.config("viterbi27"), small.frames())
    ctx = Context(s, bounds={"acs": 1.0, "walk": 1.0})
    for name in READERS:
        assert spec.reader(name)(ctx) is None


def test_readers_find_nothing_in_a_trace_without_the_ports_spans():
    ctx = _ctx(OTHER)
    for name in READERS:
        assert spec.reader(name)(ctx) is None
    # The benchmark's own readers still read it.
    assert spec.reader("device_ops_per_call")(ctx) == 3.5


def test_idle_share_is_none_where_the_device_never_waits():
    busy = [_event("kernel", "acs", 0, 70), _event("kernel", "walk", 70, 135)]
    assert spec.reader("idle_in_program_pct")(_ctx(PORT_SPANS + busy)) is None


def test_union_and_overlap():
    assert program_spans.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert program_spans.overlap([(0, 3), (5, 8)], [(2, 6), (7, 10)]) == 3.0
    assert program_spans.length([(0, 3), (5, 8)]) == 6
