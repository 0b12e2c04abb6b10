"""``acs_launches_per_call`` on synthetic Chrome traces: it counts the host's
enqueue calls inside ``ka9q.launch.acs_update*`` spans only (not those of
the walk's launcher, nor the glue in an entry span), over the traced calls,
and finds nothing without a trace or without such spans."""

import pytest

from perfbench import spec
from perfbench.cell import Context
from perfbench.trace import Trace
from perfbench.tests import small
from perfbench.tests.test_perfbench_spans import OTHER, PORT_SPANS, _runtime, _span

READ = spec.reader("acs_launches_per_call")


def _ctx(events, traced_calls):
    s = small.cell_spec(small.config("viterbi224"), small.frames(batch=8))
    return Context(s, trace=Trace(events), traced_calls=traced_calls)


def _large_k_call(t0):
    """One ICE-like call: a fill in ``ka9q.alloc``, the depth-4 launcher's
    span with its 13 launches (the entry minimum, ten octets, the 7-step
    launch, the last shift), the offset's add, the walk's launch."""
    events = [_span("ka9q.update", t0, t0 + 100), _span("ka9q.alloc", t0 + 1, t0 + 5),
              _runtime("cudaLaunchKernel", t0 + 2, t0 + 3),
              _span("ka9q.launch.acs_update_large4", t0 + 10, t0 + 80),
              _runtime("cudaLaunchKernel", t0 + 85, t0 + 86),
              _span("ka9q.chainback", t0 + 100, t0 + 120),
              _span("ka9q.launch.chainback_tb", t0 + 105, t0 + 115),
              _runtime("cudaLaunchKernel", t0 + 108, t0 + 109)]
    events += [_runtime("cudaLaunchKernel", t0 + 11 + 5 * k, t0 + 13 + 5 * k) for k in range(13)]
    return events


def test_one_launch_a_call_on_a_whole_call_route():
    # Two calls, each one enqueue inside its ka9q.launch.acs_update_inplace span.
    assert READ(_ctx(PORT_SPANS + OTHER, 2)) == pytest.approx(1.0)


def test_counts_only_enqueues_inside_acs_launch_spans():
    events = _large_k_call(0) + _large_k_call(200) + _large_k_call(400)
    # A cudaEventRecord inside the span is no enqueue; a memset is.
    events += [_runtime("cudaEventRecord", 20, 21), _runtime("cudaMemsetAsync", 215, 216)]
    assert READ(_ctx(events, 3)) == pytest.approx((3 * 13 + 1) / 3)


def test_finds_nothing_without_a_trace_or_the_ports_spans():
    s = small.cell_spec(small.config("viterbi224"), small.frames(batch=8))
    assert READ(Context(s, bounds={"acs": 1.0, "walk": 1.0})) is None
    assert READ(_ctx(OTHER, 2)) is None
    # Spans of other launchers alone are not the ACS's.
    chainback = [e for e in _large_k_call(0) if e["name"] != "ka9q.launch.acs_update_large4"]
    assert READ(_ctx(chainback, 1)) is None
    assert READ(_ctx(_large_k_call(0), 0)) is None
