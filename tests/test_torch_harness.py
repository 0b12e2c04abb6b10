"""The port's benchmark harness on the CPU: the runner emits the reference's
JSON schema, its bookkeeping equals the JAX ``BenchResult``'s, the analysis
scripts parse it, both backends decode with 0 errors (K=11 on the rotating
route included), and the entry points refuse to run without a card unless
the CPU is asked for."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.harness import bench as jbench
from ka9q_viterbi_comparison_tpu_torch.harness import bench, profiling, runner
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from test_reference_script_compat import REF_SCRIPTS as REFERENCE_SCRIPTS  # where it is mounted

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's per-test JSON schema (ref: print_test, src/main.cpp:80-118).
SCHEMA_KEYS = {
    "name", "K", "R", "poly",
    "total_input_bytes", "total_transmit_bits", "total_output_symbols",
    "sampling_time", "minimum_samples", "total_samples",
    "init_ns", "update_ns", "chainback_ns",
    "total_bits", "total_bit_errors", "bit_error_rate",
}


@pytest.fixture(scope="module")
def bench_json(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_torch") / "benchmark.json"
    runner.main(["-t", "0.05", "-n", "2", "-o", str(out), "--codes", "viterbi27", "viterbi49",
                 "--batch", "2", "--frame-bytes", "16", "--device", "cpu"])
    return out


def test_runner_emits_reference_schema(bench_json):
    rows = json.loads(bench_json.read_text())
    # viterbi27: three numeric specs, viterbi49 (no ka9q column): two; two backends each
    assert [r["name"] for r in rows] == [
        "gpu_cuda", "gpu_torch", "gpu_cuda_s16", "gpu_torch_s16", "gpu_cuda_ob", "gpu_torch_ob",
        "gpu_cuda", "gpu_torch", "gpu_cuda_s16", "gpu_torch_s16"]
    for t in rows:
        assert set(t.keys()) == SCHEMA_KEYS
        assert (t["K"], t["R"]) in ((7, 2), (9, 4))
        assert t["minimum_samples"] == 2
        assert t["total_samples"] == len(t["update_ns"]) == len(t["init_ns"]) \
            == len(t["chainback_ns"]) >= 2
        assert all(isinstance(x, int) and x > 0 for x in t["update_ns"] + t["chainback_ns"])
        assert t["total_transmit_bits"] == t["total_input_bytes"] * 8 + 2 * (t["K"] - 1)
        assert t["total_output_symbols"] == t["total_transmit_bits"] * t["R"]
        assert t["bit_error_rate"] == 0.0


@pytest.mark.parametrize("name", ["viterbi27", "viterbi615", "viterbi224"])
def test_bookkeeping_equals_the_jax_bench_result(name):
    jc = {c.name: c for c in J.STANDARD_CODES}[name]
    pc = {c.name: c for c in P.STANDARD_CODES}[name]
    samples = [(3, 5, 7), (4, 6, 8)]
    jr = jbench.BenchResult("row", jc, 512, 1024, 1.0, 8,
                            [jbench.PhaseSample(*s) for s in samples], 9)
    pr = bench.BenchResult("row", pc, 512, 1024, 1.0, 8,
                           [bench.PhaseSample(*s) for s in samples], 9)
    assert pr.to_json_obj() == jr.to_json_obj()
    assert list(pr.to_json_obj()) == list(jr.to_json_obj())  # key order too
    assert [f.name for f in dataclasses.fields(pr)] == [f.name for f in dataclasses.fields(jr)]


def test_default_batches_and_ka9q_configs_name_the_jax_rows():
    from ka9q_viterbi_comparison_tpu.harness import runner as jrunner

    assert runner.DEFAULT_BATCH == jrunner.DEFAULT_BATCH
    assert runner.KA9Q_CONFIGS == jrunner.KA9Q_CONFIGS
    assert runner.backends_for(P.VITERBI27) == ["cuda", "torch"]


def test_tabulate_script_parses_the_ports_json(bench_json):
    r = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "tabulate_data.py"),
                        str(bench_json)], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "## Update symbol rate" in r.stdout and "## Chainback bit rate" in r.stdout
    assert "gpu_cuda" in r.stdout and "gpu_torch_s16" in r.stdout


def test_reference_tabulator_parses_the_ports_json(bench_json):
    script = os.path.join(REFERENCE_SCRIPTS, "tabulate_data.py")
    if not os.path.exists(script):
        pytest.skip("the reference's scripts are not mounted")
    r = subprocess.run([sys.executable, script, str(bench_json)], capture_output=True, text=True,
                       timeout=120, cwd=REFERENCE_SCRIPTS)
    assert r.returncode == 0, r.stderr
    assert "gpu_cuda" in r.stdout


def test_runner_rejects_unknown_code_and_backend(tmp_path):
    with pytest.raises(SystemExit):
        runner.main(["-o", str(tmp_path / "x.json"), "--codes", "nonesuch", "--device", "cpu"])
    with pytest.raises(SystemExit):
        runner.main(["-o", str(tmp_path / "x.json"), "--backends", "pallas", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown backend"):
        bench._phases_for_backend(P.VITERBI27, P.soft8_spec(2), "native", 8, 2, "cpu")


def _frames(code, numeric, B, n_bytes, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    return data, encode_frames(code, numeric, torch.from_numpy(data))


K11 = P.CodeSpec("k11r2", K=11, R=2, polys=(0o3345, 0o3613))
BENCH_CASES = [
    pytest.param(P.VITERBI27, "cuda", id="viterbi27-cuda"),
    pytest.param(P.VITERBI27, "torch", id="viterbi27-torch"),
    pytest.param(P.VITERBI49, "cuda", id="viterbi49-cuda"),
    pytest.param(K11, "torch", id="k11-torch-rotating"),
    pytest.param(K11, "cuda", id="k11-cuda-large-k"),
    pytest.param(P.VITERBI615, "torch", id="viterbi615-torch-rotating"),
]


@pytest.mark.parametrize("code,backend", BENCH_CASES)
def test_run_phase_bench_decodes_without_errors(code, backend):
    numeric = P.soft8_spec(code.R)
    data, syms = _frames(code, numeric, 2, 8, seed=7)
    r = bench.run_phase_bench(code, numeric, data, syms, name=f"gpu_{backend}", backend=backend,
                              sampling_time=0.02, minimum_samples=2, device="cpu")
    assert r.total_bit_errors == 0 and len(r.samples) >= 2
    assert r.batch == 2 and r.frame_bytes == 8
    assert all(s.init_ns > 0 and s.update_ns > 0 and s.chainback_ns > 0 for s in r.samples)


def test_rotating_route_is_taken_from_k10_to_k15(monkeypatch):
    from ka9q_viterbi_comparison_tpu_torch.ops import acs

    calls = []
    real = acs.acs_update_rotating
    monkeypatch.setattr(acs, "acs_update_rotating", lambda *a: calls.append(a[0].K) or real(*a))
    for code in (P.VITERBI29, K11):
        numeric = P.soft8_spec(code.R)
        _, syms = _frames(code, numeric, 2, 2, seed=1)
        fns = bench._phases_for_backend(code, numeric, "torch", 16, 2, "cpu")
        fns[1](fns[0](2), fns[3](syms.reshape(2, -1, code.R)))
    assert calls == [11]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_time_update_marginal_and_phase_on_cpu(backend):
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    _, syms = _frames(code, numeric, 2, 16, seed=2)
    assert bench.time_update_marginal(code, numeric, syms, backend=backend, n_chain=2, iters=1,
                                      device="cpu") > 0
    assert bench.time_update_phase(code, numeric, syms.reshape(2, -1, 2), iters=2, backend=backend,
                                   device="cpu") > 0


def test_entry_points_need_a_card_unless_the_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    data, syms = _frames(code, numeric, 2, 4, seed=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run_phase_bench(code, numeric, data, syms)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.time_update_marginal(code, numeric, syms)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.main(["-o", str(tmp_path / "x.json"), "--codes", "viterbi27"])
    assert not (tmp_path / "x.json").exists()


def test_bench_torch_script(tmp_path):
    """Without a card and without ``--device cpu`` the headline script exits
    non-zero and prints no result; on the CPU it prints the one JSON line."""
    script = os.path.join(REPO, "bench_torch.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, script], capture_output=True, text=True, timeout=300,
                       env=env, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
    r = subprocess.run([sys.executable, script, "--device", "cpu", "--batch", "2", "--bytes", "16",
                        "--chain", "2", "--iters", "3"], capture_output=True, text=True,
                       timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "viterbi27_update_throughput" and line["unit"] == "Msym/s"
    assert line["value"] > 0


def test_profiling_timer_trace_and_annotate(tmp_path):
    t = profiling.Timer()
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("update"):
            torch.ones(8).sum()
    assert t.get_delta_ns() > 0 and t.get_delta_s() > 0
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any(e.key == "update" for e in prof.key_averages())
    assert bench.sync(5) == 5
