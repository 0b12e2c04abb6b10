"""The port's collective counts and analytic models, and its chip figures.

The counted collectives of each sharded path (``harness.comms.collective_trace``
over ``parallel.mesh``) against the analytic models, at the cases of
``tests/test_comms_model.py``; the models against the JAX package's for equal
``hbm``/``ici`` (dicts equal, floats to the last bit); ``utils/chipinfo.py``
resolving the H100 and flagging its fallback, with no TPU figure anywhere in
the port.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.harness import comms as jcomms
from ka9q_viterbi_comparison_tpu_torch import parallel as par
from ka9q_viterbi_comparison_tpu_torch.harness import comms
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.utils import chipinfo

CODE = P.VITERBI29
NUMERIC = P.soft8_spec(CODE.R)
PORT = pathlib.Path(__file__).resolve().parents[1] / "ka9q_viterbi_comparison_tpu_torch"


def _jcode(code):
    return {c.name: c for c in J.STANDARD_CODES}[code.name]


def _syms(B, n_bytes, seed=11):
    data = np.random.default_rng(seed).integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    syms = encode_frames(CODE, NUMERIC, torch.from_numpy(data))
    T = CODE.transmit_bits(n_bytes)
    return syms, syms.reshape(B, T, CODE.R), T


def test_statewise_counts_match_model():
    B, n_state = 2, 4
    _, syms3, T = _syms(B, 8)
    mesh = par.Mesh({"state": n_state}, "cpu")
    rep = comms.collective_trace(
        lambda s: par.state_sharded_decode_bits(CODE, NUMERIC, s, mesh), syms3)
    model = comms.statewise_model(CODE, n_state, B, T)
    # Update: 4 half-shard ppermutes per trellis step.
    assert rep.total_count("ppermute") == model["update_ppermutes"] == 4 * T
    perms = [c for c in rep.collectives if c.prim == "ppermute"]
    assert len(perms) == 4 and all(c.count == T and c.shape == (B, CODE.num_states // 8)
                                   for c in perms)
    step_wire = sum(c.wire_bytes for c in perms)
    assert step_wire == model["step_wire_bytes"] == 4 * B * CODE.num_states
    # Traceback: one psum of [B] int32 per step.
    psums = [c for c in rep.collectives if c.prim.startswith("psum")]
    assert sum(c.count for c in psums) == model["traceback_psums"] == T
    assert all(c.payload_bytes == model["traceback_psum_bytes"] and c.dtype == "int32"
               for c in psums)
    assert rep.total_count() == 5 * T  # nothing else


def test_timeblock_counts_match_model():
    B, n_time, OL = 2, 4, 24
    _, syms3, T = _syms(B, 36)  # T = 296, divisible by 4
    mesh = par.Mesh({"time": n_time}, "cpu")
    rep = comms.collective_trace(
        lambda s: par.time_block_decode_bits(CODE, NUMERIC, s, mesh, overlap=OL), syms3)
    model = comms.timeblock_model(CODE, n_time, B, T, overlap=OL)
    perms = [c for c in rep.collectives if c.prim == "ppermute"]
    # Exactly two one-shot halo exchanges per frame, never per step.
    assert sum(c.count for c in perms) == model["halo_ppermutes"] == 2
    assert all(c.payload_bytes == model["halo_payload_bytes"] for c in perms)
    assert all(c.pairs == n_time - 1 for c in perms)
    assert rep.total_wire_bytes("ppermute") == model["total_wire_bytes"]
    assert rep.total_count() == 2


def test_state_time_counts_match_model():
    B, n_state, n_time, OL = 1, 2, 2, 24
    _, syms3, T = _syms(B, 32)  # T = 264, divisible by 2
    mesh = par.Mesh({"state": n_state, "time": n_time}, "cpu")
    rep = comms.collective_trace(
        lambda s: par.state_time_decode_bits(CODE, NUMERIC, s, mesh, overlap=OL), syms3)
    model = comms.state_time_model(CODE, n_state, n_time, B, T, overlap=OL)
    Tb = T // n_time
    state_perms = [c for c in rep.collectives if c.prim == "ppermute" and c.axes == ("state",)]
    time_perms = [c for c in rep.collectives if c.prim == "ppermute" and c.axes == ("time",)]
    # Butterfly exchange in the warm-up (OL steps) and main (Tb + OL steps) scans.
    assert (sum(c.count for c in state_perms) == model["update_ppermutes_per_device_stream"]
            == 4 * (Tb + 2 * OL))
    # The four per-step calls sum to one metric-vector copy, as pure state
    # sharding's do: composing the time axis adds no bytes a step.
    pure = comms.statewise_model(CODE, n_state, B, Tb + 2 * OL)
    assert (sum(c.wire_bytes for c in state_perms) == pure["step_wire_bytes"]
            == model["step_wire_bytes"] == 4 * B * CODE.num_states)
    # Symbol halos: one-shot, along time only.
    assert sum(c.count for c in time_perms) == 2
    assert all(c.payload_bytes == model["halo_payload_bytes"] for c in time_perms)
    # Tracebacks are block-local: Tb + OL psums, not T; two pmins find the end state.
    psums = [c for c in rep.collectives if c.prim.startswith("psum")]
    assert sum(c.count for c in psums) == model["traceback_psums"] == Tb + OL
    assert rep.total_count("pmin") == 2


def test_frame_dp_has_zero_collectives():
    syms, _, _ = _syms(8, 8)
    mesh = par.make_frame_mesh(4, device="cpu")
    rep = comms.collective_trace(
        lambda s: par.frame_sharded_decode(CODE, NUMERIC, s, 8 * 8, mesh), syms)
    assert rep.collectives == []
    assert comms.frame_model(4, 8)["predicted_efficiency"] == 1.0


def test_report_json_and_totals():
    _, syms3, T = _syms(2, 8)
    rep = comms.collective_trace(
        lambda s: par.state_sharded_decode_bits(CODE, NUMERIC, s, par.Mesh({"state": 2}, "cpu")),
        syms3)
    obj = rep.to_json_obj()
    assert obj["total_wire_bytes"] == rep.total_wire_bytes() == sum(
        c["wire_bytes"] * c["count"] for c in obj["collectives"])


BANDWIDTHS = [(819e9, 180e9), (3.35e12, 450e9), (2.0e12, 300e9)]


@pytest.mark.parametrize("hbm,ici", BANDWIDTHS)
@pytest.mark.parametrize("code,n", [(P.VITERBI29, 4), (P.VITERBI224, 8), (P.VITERBI224, 1),
                                    (P.VITERBI615, 2)])
def test_statewise_model_equals_jax(code, n, hbm, ici):
    assert (comms.statewise_model(code, n, 8, 87, hbm=hbm, ici=ici)
            == jcomms.statewise_model(_jcode(code), n, 8, 87, hbm=hbm, ici=ici))


@pytest.mark.parametrize("hbm,ici", BANDWIDTHS)
@pytest.mark.parametrize("overlap", [None, 24])
@pytest.mark.parametrize("code,n,T", [(P.VITERBI27, 4, 8200), (P.VITERBI29, 8, 32776),
                                      (P.VITERBI27, 1, 518)])
def test_timeblock_model_equals_jax(code, n, T, overlap, hbm, ici):
    assert (comms.timeblock_model(code, n, 64, T, overlap=overlap, hbm=hbm, ici=ici)
            == jcomms.timeblock_model(_jcode(code), n, 64, T, overlap=overlap, hbm=hbm, ici=ici))


@pytest.mark.parametrize("n_state,n_time,overlap", [(2, 2, 24), (4, 2, 96), (2, 4, None)])
def test_state_time_model_equals_jax(n_state, n_time, overlap):
    # The JAX model takes its bandwidths from its own chip info (no
    # arguments); the port's is given the same.
    hbm, ici = jcomms.HBM_BYTES_PER_S, jcomms.ICI_EGRESS_BYTES_PER_S
    for code, T in ((P.VITERBI29, 264), (P.VITERBI224, 536)):
        assert (comms.state_time_model(code, n_state, n_time, 1, T, overlap, hbm=hbm, ici=ici)
                == jcomms.state_time_model(_jcode(code), n_state, n_time, 1, T, overlap))


def test_frame_model_equals_jax():
    assert comms.frame_model(4, 512) == jcomms.frame_model(4, 512)


def test_models_default_to_the_h100_figures():
    info = chipinfo.chip_info()
    assert comms.HBM_BYTES_PER_S == info.hbm_bytes_per_s
    assert comms.ICI_EGRESS_BYTES_PER_S == info.ici_egress_bytes_per_s
    assert (comms.statewise_model(P.VITERBI224, 4, 8, 87)
            == comms.statewise_model(P.VITERBI224, 4, 8, 87, hbm=info.hbm_bytes_per_s,
                                     ici=info.ici_egress_bytes_per_s))
    # What the H100 figures predict: frame DP and a long time block scale,
    # state sharding is bound by NVLink (8.125 bytes of HBM against 4 of
    # NVLink a state and step, at 3.35 TB/s against 450 GB/s).
    assert comms.frame_model(4, 512)["predicted_efficiency"] == 1.0
    tb = comms.timeblock_model(P.VITERBI27, 4, 512, 8200, hbm=3.35e12, ici=450e9)
    assert tb["predicted_efficiency"] > 0.85
    sw = comms.statewise_model(P.VITERBI224, 4, 8, 87, hbm=3.35e12, ici=450e9)
    assert sw["predicted_step_efficiency"] == pytest.approx(8.125 / 3.35e12 / (4 / 450e9))


def test_chip_info_resolves_the_h100():
    info = chipinfo.resolve("NVIDIA H100 80GB HBM3")
    assert not info.assumed and info.device_kind == "NVIDIA H100 80GB HBM3"
    assert (info.hbm_bytes_per_s, info.ici_egress_bytes_per_s) == (3.35e12, 450e9)
    pcie = chipinfo.resolve("NVIDIA H100 PCIe")
    assert (pcie.hbm_bytes_per_s, pcie.ici_egress_bytes_per_s, pcie.assumed) == (2.0e12, 300e9,
                                                                                 False)
    unknown = chipinfo.resolve("NVIDIA Z900")
    assert unknown.assumed and unknown.device_kind == "NVIDIA Z900"
    assert unknown.hbm_bytes_per_s == 3.35e12


@pytest.mark.parametrize("name", ["NVIDIA H100 NVL", "NVIDIA H100", "NVIDIA H100 PCIe 94GB"])
def test_chip_info_flags_a_name_it_only_contains(name):
    """A name that contains a part's but is not its exact device name gets
    that part's figures, flagged assumed (an H100 NVL is neither part)."""
    info = chipinfo.resolve(name)
    part = chipinfo.H100_PCIE if "pcie" in name.lower() else chipinfo.H100_SXM
    assert info.assumed and info.device_kind == name
    assert (info.hbm_bytes_per_s, info.ici_egress_bytes_per_s) == (part.hbm_bytes_per_s,
                                                                   part.ici_egress_bytes_per_s)


def test_chip_info_on_the_cpu_is_assumed():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: its figures are detected")
    info = chipinfo.chip_info()
    assert info.assumed and info.device_kind == ""
    assert (info.hbm_bytes_per_s, info.ici_egress_bytes_per_s) == (3.35e12, 450e9)
    assert {f for f in vars(info)} == {"name", "device_kind", "hbm_bytes_per_s",
                                        "ici_egress_bytes_per_s", "assumed"}


# A TPU's figures: v5e HBM 819 GB/s, 45 GB/s ICI links, VMEM.
TPU_FIGURE = re.compile(r"\b819\s*(e9|GB)|\b45\s*(e9|GB)|\bvmem", re.IGNORECASE)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + sorted((PORT / "csrc").glob("*")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_tpu_figure_in_the_port(path):
    hits = [ln for ln in path.read_text().splitlines() if TPU_FIGURE.search(ln)]
    assert not hits, hits
