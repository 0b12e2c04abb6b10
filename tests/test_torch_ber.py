"""The port's BER harness.

``BerPoint``'s derived values equal the JAX ``BerPoint``'s on the same
counts (exactly); the port's measured BER falls as Eb/N0 rises; and at 0 and
1 dB -- many errors from few frames -- the port's 95 % Wilson interval
overlaps the interval of the published point in ``data/ber_viterbi27.json``
(the JAX package's measurement: VITERBI27 soft16, 128-byte frames, batches of
64, seed 0, 262 144 bits), measured here with the same frames (the same numpy
seed) and the port's own noise, on the kernels' plain versions."""

import json
import pathlib

import pytest

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.harness import ber as jber
from ka9q_viterbi_comparison_tpu_torch.harness import ber

DATA = pathlib.Path(__file__).resolve().parents[1] / "data"


@pytest.mark.parametrize("counts", [
    (0.0, 262144, 48578, 256, 256), (3.0, 524288, 343, 512, 58), (5.0, 154927104, 101, 151296, 9),
    (2.5, 1000, 0, 8, 0), (1.0, 0, 0, 0, 0), (-1.0, 64, 64, 1, 1)])
def test_ber_point_equals_jax(counts):
    p, j = ber.BerPoint(*counts), jber.BerPoint(*counts)
    assert (p.ber, p.fer, p.uncoded_ber) == (j.ber, j.fer, j.uncoded_ber)
    assert p.ber_ci() == j.ber_ci() and p.ber_ci(2.58) == j.ber_ci(2.58)


def test_ber_monotone_in_snr():
    code, spec = P.VITERBI27, P.soft16_spec(2)
    points = ber.ber_curve(code, spec, [0.0, 3.0, 6.0], frame_bytes=32, batch=16, min_errors=20,
                           max_bits=200_000, device="cpu")
    lo, mid, hi = points
    assert lo.errors > 0 and lo.bits > 0
    assert lo.ber > mid.ber > hi.ber
    assert hi.ber < 1e-3  # 6 dB with K=7 soft decisions: essentially error-free here
    assert mid.ber < mid.uncoded_ber  # coding gain at 3 dB


@pytest.mark.parametrize("ebn0", [0.0, 1.0])
def test_wilson_interval_overlaps_the_published_point(ebn0):
    published = {p["ebn0_db"]: p for p in json.loads((DATA / "ber_viterbi27.json").read_text())}
    want = published[ebn0]
    got = ber.measure_ber(P.VITERBI27, P.soft16_spec(2), ebn0, frame_bytes=128, batch=64,
                          min_errors=10 ** 9, max_bits=want["bits"], seed=0, device="cpu")
    assert got.bits == want["bits"] and got.errors > 1000
    lo, hi = got.ber_ci()
    assert lo <= want["ber_ci"][1] and want["ber_ci"][0] <= hi, (got.ber_ci(), want["ber_ci"])
