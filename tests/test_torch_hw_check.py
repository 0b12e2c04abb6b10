"""The port's hardware check (``harness/hw_check.py``) on the CPU.

Its decodes against the JAX package's ``decode_frames(..., backend="jnp")``
on the same symbols, byte for byte; its ``ok`` and ``all_ok`` logic under a
backend that disagrees, a noiseless error and the canary off the in-place
route; the checked-in ``data/hw_check_torch.json`` (a run on the card)
against the schema; and the CLI, which raises without a card unless given
``--device cpu``.  Small shapes: K=7 and K=9 r=1/2, B=4, 16-byte frames.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.models.decoder import decode_frames as jax_decode_frames
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames as jax_encode_frames
from ka9q_viterbi_comparison_tpu_torch import configs
from ka9q_viterbi_comparison_tpu_torch.harness import hw_check
from ka9q_viterbi_comparison_tpu_torch.models.decoder import BACKENDS
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "data" / "hw_check_torch.json"
CPU = torch.device("cpu")
B, N_BYTES = 4, 16
CODES = ["viterbi27", "viterbi29"]


def codes(name):
    """The JAX package's code and the port's, by name."""
    jc = next(c for c in J.STANDARD_CODES if c.name == name)
    pc = next(c for c in configs.STANDARD_CODES if c.name == name)
    return jc, pc


def jax_decode(jc, sym: np.ndarray) -> np.ndarray:
    return np.asarray(jax_decode_frames(jc, J.soft8_spec(jc.R), jnp.asarray(sym), N_BYTES * 8,
                                        backend="jnp"))


@pytest.mark.parametrize("symbols", ["noiseless", "numpy_noise", "awgn"])
@pytest.mark.parametrize("name", CODES)
def test_check_decodes_match_jax(name, symbols):
    """Both backends of the check decode the bytes JAX's ``jnp`` backend
    decodes, on the same symbols: the encoder's, those plus Gaussian noise
    made by numpy, and the check's own AWGN symbols (``make_frames``)."""
    jc, pc = codes(name)
    jn = J.soft8_spec(jc.R)
    rng = np.random.default_rng(16)
    data, clean, noisy = hw_check.make_frames(pc, B, N_BYTES, rng, CPU)
    want_clean = np.array(jax_encode_frames(jc, jn, jnp.asarray(data)))
    np.testing.assert_array_equal(clean.numpy(), want_clean)
    if symbols == "noiseless":
        sym = want_clean
    elif symbols == "numpy_noise":
        amp = (jn.soft_high - jn.soft_low) / 2
        sym = np.clip(np.round(want_clean + rng.normal(0.0, 1.2 * amp, want_clean.shape)),
                      jn.soft_low, jn.soft_high).astype(np.int32)
    else:
        sym = noisy.numpy()
    want = jax_decode(jc, sym)
    if symbols == "noiseless":
        np.testing.assert_array_equal(want, data)
    for backend in BACKENDS:
        got = hw_check.decode(pc, torch.from_numpy(sym), N_BYTES, backend)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {symbols} {backend}")
    if symbols == "numpy_noise":
        assert (want != data).any(), "the noise should leave errors for the decoders to agree on"


@pytest.mark.parametrize("name", CODES)
def test_check_code_row_matches_jax(name):
    """``check_code``'s row at a small size: the same seed gives the frames
    that JAX decodes with 0 noiseless errors and the row's BER."""
    jc, pc = codes(name)
    row = hw_check.check_code(pc, np.random.default_rng(5), N_BYTES, B, CPU)
    data, clean, noisy = hw_check.make_frames(pc, B, N_BYTES, np.random.default_rng(5), CPU)
    assert (row["name"], row["K"], row["R"], row["frame_bytes"], row["batch"]) == (
        name, pc.K, pc.R, N_BYTES, B)
    assert row["noiseless_bit_errors_cuda"] == row["noiseless_bit_errors_torch"] == 0
    assert np.array_equal(jax_decode(jc, clean.numpy()), data)
    n_bad = int(np.unpackbits(jax_decode(jc, noisy.numpy()) ^ data).sum())
    assert row["awgn_ber_vs_transmitted"] == n_bad / (B * N_BYTES * 8)
    assert row["awgn_backend_bit_agreement"] and row["ok"]
    assert row["route"] == {"use_inplace": False, "supports": True, "large_k_depth": None}
    assert row["launches"] == {"cuda": {}, "torch": {}}, "no kernel runs on the CPU"
    assert row["seconds"] >= row["decode_seconds"]["cuda"] + row["decode_seconds"]["torch"]


def corrupting_decode(monkeypatch, backend, which):
    """Make ``hw_check.decode`` flip one bit of ``backend``'s decode of the
    ``which`` ("clean" or "noisy") symbols of the frames being checked."""
    made = []
    real_make, real_decode = hw_check.make_frames, hw_check.decode

    def make(*args):
        made.append(real_make(*args))
        return made[-1]

    def decode(code, symbols, n_bytes, be):
        out = real_decode(code, symbols, n_bytes, be)
        if be == backend and symbols is made[-1][1 if which == "clean" else 2]:
            out[0, 0] ^= 1
        return out

    monkeypatch.setattr(hw_check, "make_frames", make)
    monkeypatch.setattr(hw_check, "decode", decode)


@pytest.mark.parametrize("backend,which,field", [
    ("torch", "noisy", "awgn_backend_bit_agreement"),
    ("cuda", "noisy", "awgn_backend_bit_agreement"),
    ("cuda", "clean", "noiseless_bit_errors_cuda"),
    ("torch", "clean", "noiseless_bit_errors_torch"),
])
def test_ok_turns_false(monkeypatch, backend, which, field):
    pc = codes("viterbi27")[1]
    good = hw_check.check_code(pc, np.random.default_rng(0), N_BYTES, B, CPU)
    corrupting_decode(monkeypatch, backend, which)
    row = hw_check.check_code(pc, np.random.default_rng(0), N_BYTES, B, CPU)
    assert good["ok"] and row["ok"] is False
    assert row[field] is False if field == "awgn_backend_bit_agreement" else row[field] == 1
    envelope = {"ok": True}
    assert hw_check.all_ok([good], envelope) and not hw_check.all_ok([good, row], envelope)


def test_envelope_ok_and_route(monkeypatch):
    """The canary at 1-byte frames: both batches on the in-place route and
    exact; with B=256 moved off the route (monkeypatched) ``ok`` and
    ``all_ok`` turn false, as they do on a bit error at B=512."""
    env = hw_check.check_inplace_envelope(np.random.default_rng(0), 1, CPU)
    for key, batch in (("b256", 256), ("b512", 512)):
        assert env[key]["batch"] == batch and env[key]["frame_bytes"] == 1
        assert env[key]["routed_inplace"] and env[key]["bit_errors"] == 0
        assert env[key]["smem_bytes"] == 200448 and env[key]["smem_optin_bytes"] is None
    assert env["ok"] and env["b512_expected_inplace"] is True
    assert hw_check.all_ok([], env)

    bad512 = {**env, "b512": {**env["b512"], "bit_errors": 3}}
    assert not hw_check.envelope_ok(bad512)

    real = dispatch.use_inplace
    monkeypatch.setattr(dispatch, "use_inplace",
                        lambda code, batch, device="cpu": batch != 256 and real(code, batch, device))
    moved = hw_check.check_inplace_envelope(np.random.default_rng(0), 1, CPU)
    assert not moved["b256"]["routed_inplace"] and moved["b256"]["bit_errors"] == 0
    assert moved["b512"]["routed_inplace"]
    assert moved["ok"] is False and not hw_check.all_ok([], moved)


def test_checked_in_artifact_schema():
    """``data/hw_check_torch.json``: a run on the card at the reference's
    frame sizes and the JAX tool's batches, every row as its checks imply."""
    art = json.loads(ARTIFACT.read_text())
    assert art["platform"] == "gpu"
    assert art["device_kind"].startswith("NVIDIA ")
    assert art["card"].startswith(art["device_kind"] + ", ") and art["card"].endswith(" W")
    assert isinstance(art["seed"], int)
    rows = art["configs"]
    assert [r["name"] for r in rows] == [c.name for c in configs.STANDARD_CODES]
    for r in rows:
        assert r["frame_bytes"] == configs.BENCH_FRAME_BYTES[r["name"]]
        assert r["batch"] == hw_check.CHECK_BATCH[r["name"]]
        assert r["awgn_ebn0_db"] == hw_check.EBN0_DB
        assert 0.0 <= r["awgn_ber_vs_transmitted"] < 0.5
        assert r["ok"] == hw_check.code_ok(r)
        assert set(r["route"]) == {"use_inplace", "supports", "large_k_depth"}
        assert r["launches"]["cuda"], f"{r['name']}: no kernel launch recorded on the card"
        assert r["seconds"] > 0
    env = art["inplace_envelope"]
    for key, batch in (("b256", 256), ("b512", 512)):
        row = env[key]
        assert row["batch"] == batch and row["frame_bytes"] == configs.BENCH_FRAME_BYTES["viterbi615"]
        assert {"routed_inplace", "bit_errors", "smem_bytes", "smem_optin_bytes", "launches",
                "seconds"} <= set(row)
        assert row["smem_optin_bytes"] is not None
    assert env["ok"] == hw_check.envelope_ok(env)
    assert env["b512_expected_inplace"] is True
    assert art["all_ok"] == hw_check.all_ok(rows, env)


def test_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "hw.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hw_check.main(["-o", str(out)])
    assert not out.exists()

    # On the CPU at a small size: two codes, 2-byte frames, the canary at 1-byte frames.
    real_code, real_env = hw_check.check_code, hw_check.check_inplace_envelope
    monkeypatch.setattr(hw_check, "STANDARD_CODES", configs.STANDARD_CODES[:2])
    monkeypatch.setattr(hw_check, "check_code",
                        lambda code, rng, device: real_code(code, rng, 2, 2, device))
    monkeypatch.setattr(hw_check, "check_inplace_envelope",
                        lambda rng, device: real_env(rng, 1, device))
    assert hw_check.main(["-o", str(out), "--device", "cpu", "--seed", "3"]) == 0
    art = json.loads(out.read_text())
    assert (art["platform"], art["device_kind"], art["card"], art["seed"]) == ("cpu", "cpu", "CPU", 3)
    assert art["all_ok"] and len(art["configs"]) == 2 and art["inplace_envelope"]["ok"]
