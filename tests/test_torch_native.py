"""The port's host-side oracles: the NumPy oracle and the native C++ decoder.

Their encoders equal the port's; on noisy symbols both decode byte-identical
to the port's decode, with the same path metric; every code round-trips
through the host decoder; the runner's ``cpu_native`` rows decode with 0
errors.  The port's build of the host library is atomic: six processes that
start on an empty build directory all find ``available()`` True, and the
library lies in the port's ``_build/``, never under ``native/build/``."""

import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import oracle as joracle
from ka9q_viterbi_comparison_tpu_torch.harness import runner
from ka9q_viterbi_comparison_tpu_torch.ops import oracle
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "ka9q_viterbi_comparison_tpu_torch"
HAVE_GXX = shutil.which("g++") is not None
needs_gxx = pytest.mark.skipif(not HAVE_GXX, reason="no g++")

SMALL_BYTES = {"viterbi27": 64, "viterbi47": 64, "viterbi29": 32,
               "viterbi49": 32, "viterbi615": 8, "viterbi224": 2}


def _noisy(code, numeric, B, n_bytes, seed, noise):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    clean = encode_frames(code, numeric, torch.from_numpy(data)).numpy()
    sym = np.clip(clean + rng.integers(-noise, noise + 1, size=clean.shape), numeric.soft_low,
                  numeric.soft_high).astype(np.int32)
    return data, sym


@pytest.mark.parametrize("code", P.STANDARD_CODES, ids=lambda c: c.name)
def test_oracle_encoder_equals_the_ports(code):
    numeric = P.soft8_spec(code.R)
    data = np.random.default_rng(1).integers(0, 256, size=SMALL_BYTES[code.name], dtype=np.uint8)
    want = encode_frames(code, numeric, torch.from_numpy(data[None]))[0].numpy()
    np.testing.assert_array_equal(oracle.oracle_encode(code, numeric, data), want)


@pytest.mark.parametrize("name", ["viterbi27", "viterbi49"])
def test_oracle_is_the_jax_packages(name):
    """The port's copy of the oracle gives the JAX package's outputs."""
    import ka9q_viterbi_comparison_tpu as J

    pc = {c.name: c for c in P.STANDARD_CODES}[name]
    jc = {c.name: c for c in J.STANDARD_CODES}[name]
    data, sym = _noisy(pc, P.soft8_spec(pc.R), 1, SMALL_BYTES[name], 2, 3)
    got = oracle.oracle_decode(pc, P.soft8_spec(pc.R), sym[0], SMALL_BYTES[name] * 8)
    want = joracle.oracle_decode(jc, J.soft8_spec(jc.R), sym[0], SMALL_BYTES[name] * 8)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("name", ["viterbi27", "viterbi29", "viterbi615"])
def test_oracle_and_host_decoder_equal_the_ports_decode_on_noisy_symbols(name):
    code = {c.name: c for c in P.STANDARD_CODES}[name]
    numeric = P.soft16_spec(code.R)
    n = SMALL_BYTES[name]
    data, sym = _noisy(code, numeric, 3, n, 3, 254)
    dec = P.ViterbiDecoder(code, numeric, 3, device="cpu")
    dec.update(sym)
    want, pm = dec.chainback(n * 8).numpy(), dec.path_metric(0).numpy()
    assert (pm > 0).all()  # every frame's survivor carries noise
    if code.R == 2:
        assert (want != data).any()  # noisy enough to decode wrongly somewhere
    for b in range(3):
        out_o, pm_o = oracle.oracle_decode(code, numeric, sym[b], n * 8)
        np.testing.assert_array_equal(out_o, want[b])
        assert pm_o == pm[b]
        if HAVE_GXX:
            out_n, pm_n = native.decode(code, numeric, sym[b], n)
            np.testing.assert_array_equal(out_n, want[b])
            assert pm_n == pm[b]


@needs_gxx
@pytest.mark.parametrize("code", P.STANDARD_CODES, ids=lambda c: c.name)
def test_native_roundtrip(code):
    numeric = P.soft8_spec(code.R)
    n = SMALL_BYTES[code.name]
    data = np.random.default_rng(4).integers(0, 256, size=n, dtype=np.uint8)
    syms = native.encode(code, numeric, data)
    np.testing.assert_array_equal(syms, oracle.oracle_encode(code, numeric, data))
    out, pm = native.decode(code, numeric, syms, n)
    np.testing.assert_array_equal(out, data)
    assert pm == 0


@needs_gxx
def test_host_decoder_lifecycle_and_bit_errors():
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    data, sym = _noisy(code, numeric, 1, 32, 5, 2)
    hd = native.HostDecoder(code, numeric, max_steps=0)
    hd.reset()
    half = (sym.shape[1] // 4) * 2
    hd.update(sym[0, :half])
    hd.update(sym[0, half:])  # resumable in blocks
    out, pm = hd.chainback(32)
    np.testing.assert_array_equal(out, native.decode(code, numeric, sym[0], 32)[0])
    assert pm == native.decode(code, numeric, sym[0], 32)[1]
    a = np.array([0xFF, 0x00, 0xAA], dtype=np.uint8)
    b = np.array([0x0F, 0x00, 0x55], dtype=np.uint8)
    assert native.bit_errors(a, b) == 4 + 0 + 8


@needs_gxx
def test_runner_native_rows(tmp_path):
    out = tmp_path / "native.json"
    runner.main(["-t", "0.02", "-n", "2", "-o", str(out), "--codes", "viterbi27", "viterbi615",
                 "--frame-bytes", "8", "--backends", "native", "--device", "cpu"])
    rows = json.loads(out.read_text())
    assert [r["name"] for r in rows] == ["cpu_native", "cpu_native_s16", "cpu_native_ob"] * 2
    for r in rows:
        batch = runner.NATIVE_BATCH["viterbi27" if r["K"] == 7 else "viterbi615"]
        assert r["total_input_bytes"] == batch * 8
        assert r["bit_error_rate"] == 0.0 and r["total_samples"] >= 2


@needs_gxx
def test_library_lies_in_the_ports_build_directory():
    assert native.available()
    lib = native.library_path()
    assert lib.exists() and lib.parent == PORT / "_build"
    assert REPO / "native" not in lib.parents


_PROBE = """
import pathlib, sys, time
ready, go = pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2])
from ka9q_viterbi_comparison_tpu_torch.utils import native
ready.touch()
deadline = time.time() + 60
while not go.exists() and time.time() < deadline:
    time.sleep(0.005)
print(native.available(), native.library_path())
"""


@needs_gxx
def test_concurrent_first_builds_all_succeed(tmp_path):
    """Six processes on a copy of the port with an empty build directory,
    released together, all load the library one of them built; the build
    leaves no temporary file behind."""
    shutil.copytree(PORT, tmp_path / PORT.name, ignore=shutil.ignore_patterns("_build",
                                                                              "__pycache__"))
    (tmp_path / "native").mkdir()
    shutil.copy(REPO / "native" / "viterbi_host.cpp", tmp_path / "native")
    go = tmp_path / "go"
    ready = [tmp_path / f"ready{i}" for i in range(6)]
    procs = [subprocess.Popen([sys.executable, "-c", _PROBE, str(r), str(go)], cwd=tmp_path,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in ready]
    deadline = time.time() + 120
    while not all(r.exists() for r in ready) and time.time() < deadline:
        time.sleep(0.01)
    go.touch()
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    built = tmp_path / PORT.name / "_build"
    assert all(o.startswith("True ") for o, _ in outs), outs
    assert {o.split()[1] for o, _ in outs} == {str(built / native.library_path().name)}
    assert sorted(p.name for p in built.iterdir()) == [native.library_path().name,
                                                        "viterbi_host.lock"]
    assert not (tmp_path / "native" / "build").exists()
