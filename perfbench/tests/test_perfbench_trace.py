"""The roofline arithmetic against the port's kernel table, and the trace
readers on a small synthetic Chrome trace."""

import pytest

from perfbench import roofline, spec
from perfbench.cell import Context
from perfbench.trace import Trace
from perfbench.tests import small


@pytest.mark.parametrize("K,R,B,T,ms", [
    (7, 2, 512, 8198, 0.0983),     # in place, K=7 B=512, 1024-byte frames
    (15, 6, 256, 2062, 3.1138),    # Cassini B=256, 256-byte frames
    (15, 6, 64, 2062, 0.7785),     # Cassini B=64
])
def test_acs_bound_reproduces_kernel_table(K, R, B, T, ms):
    assert round(roofline.acs_bound_s(K, R, B, T) * 1e3, 4) == ms


def test_walk_bound_reproduces_kernel_table():
    # The in-place walk at K=7 B=512, its bytes form (a byte a data byte).
    assert round(roofline.walk_bound_s(512, 8198, 512 * 1024) * 1e3, 6) == 0.005169


def test_peaks():
    assert roofline.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9, rel=1e-3)
    assert roofline.HBM_BYTES_PER_S == 3.35e12


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = [
    _event("user_annotation", "issue", 0, 100),
    _event("cpu_op", "aten::empty", 40, 10),
    _event("kernel", "void acs_kernel<7>(Args)", 10, 30),
    _event("gpu_memset", "Memset (Device)", 40, 5),
    _event("kernel", "void chainback_kernel<true, 2>(Args)", 50, 20),
    _event("kernel", "void acs_kernel<7>(Args)", 70, 30),
    _event("kernel", "void chainback_kernel<true, 2>(Args)", 90, 20),  # overlaps the one before
    _event("gpu_user_annotation", "ignored", 0, 200),
    _event("cuda_runtime", "cudaLaunchKernel", 5, 2),
]


def test_trace_reading():
    tr = Trace(TRACE)
    assert len(tr.ops) == 5
    assert tr.window_us() == 100.0  # 10 .. 110
    assert tr.busy_us() == 95.0     # 10-45 and 50-110
    assert tr.time_us("acs_kernel") == 60.0
    assert tr.by_name()[0] == ("void acs_kernel<7>(Args)", pytest.approx(60e-6))
    assert tr.gaps() == [("aten::empty", pytest.approx(5e-6))]


def test_readers():
    s = small.cell_spec(small.config("viterbi27"), small.frames())
    s.kernels = {"acs_kernel": "acs_kernel", "walk_kernel": "chainback_kernel"}
    ctx = Context(s, trace=Trace(TRACE), traced_calls=2, issue_s=[100e-6, 300e-6],
                  bounds={"acs": 15e-6, "walk": 4e-6})
    read = {name: spec.reader(name)(ctx) for name in
            ("host_issue_us", "device_ops_per_call", "acs_roofline", "walk_roofline",
             "device_idle_pct")}
    assert read["host_issue_us"] == pytest.approx(200.0)
    assert read["device_ops_per_call"] == 2.5
    assert read["acs_roofline"] == pytest.approx(50.0)   # 15 us of bound against 30 us a call
    assert read["walk_roofline"] == pytest.approx(20.0)  # 4 against 20
    assert read["device_idle_pct"] == pytest.approx(5.0)


def test_readers_find_nothing_without_a_trace():
    s = small.cell_spec(small.config("viterbi27"), small.frames())
    ctx = Context(s, bounds={"acs": 1.0, "walk": 1.0})
    for name in ("device_ops_per_call", "acs_roofline", "walk_roofline", "device_idle_pct",
                 "host_issue_us"):
        assert spec.reader(name)(ctx) is None


def test_every_benchmark_metric_has_a_reader_and_every_cell_its_files():
    import json
    bench = json.load(open(spec.ROOT / "BENCHMARK.json"))
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        s = spec.load(w["name"], bench)
        assert {"acs_kernel", "walk_kernel"} <= set(s.kernels)
        assert s.per_layer and s.end_to_end
