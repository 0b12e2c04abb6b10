"""The port's AWGN channel against the JAX package's and against theory.

``ebn0_sigma`` must give the JAX float exactly.  The noise cannot be the JAX
package's (``jax.random`` streams are not reproducible in PyTorch), so it is
held to theory: on a seeded CPU ``torch.Generator``, the distance of each
received symbol from its transmitted rail, in units of the half-span, has
the mean, the second moment and the share of symbols at a rail that a
Gaussian of the channel's sigma, rounded to the soft alphabet and clipped at
the rails, gives -- each within five standard errors of the sample.  Decodes
are held byte-identical to the JAX ``decode_symbols`` on AWGN symbols the
JAX side made."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.models.functional import decode_symbols as jdecode
from ka9q_viterbi_comparison_tpu.ops import channel as jchannel
from ka9q_viterbi_comparison_tpu_torch.ops import channel
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames

CODES = [(P.STANDARD_CODES[i], J.STANDARD_CODES[i]) for i in range(len(P.STANDARD_CODES))]


def _q(x):
    return 0.5 * math.erfc(x / math.sqrt(2))


def _phi(x):
    return math.exp(-x * x / 2) / math.sqrt(2 * math.pi)


@pytest.mark.parametrize("ebn0", [-1.0, 0.0, 2.5, 3.0, 10.0])
@pytest.mark.parametrize("codes", CODES, ids=lambda c: c[0].name)
def test_ebn0_sigma_equals_jax(codes, ebn0):
    pc, jc = codes
    assert channel.ebn0_sigma(pc, ebn0) == jchannel.ebn0_sigma(jc, ebn0)


@pytest.mark.parametrize("ebn0", [1.0, 3.0])
def test_noise_matches_theory(ebn0):
    code, numeric = P.VITERBI27, P.soft16_spec(2)
    seed = 11 + int(ebn0)  # independent draws at each point
    data = np.random.default_rng(seed).integers(0, 256, size=(64, 256), dtype=np.uint8)
    gen = torch.Generator().manual_seed(seed)
    rx = channel.awgn_symbols(code, numeric, data, ebn0, gen, device="cpu").double()
    clean = encode_frames(code, numeric, torch.from_numpy(data)).double()
    amp = (numeric.soft_high - numeric.soft_low) / 2
    d = ((rx - clean).abs() / amp).flatten()
    n = d.numel()
    sigma = channel.ebn0_sigma(code, ebn0)
    c = 2 / sigma  # the far rail, in sigmas
    # d = min(sigma |Z|, 2) when the noise points inward (half the time), else 0
    mean = sigma * (_phi(0) - _phi(c)) + 2 * _q(c)
    second = sigma ** 2 * ((0.5 - _q(c)) - c * _phi(c)) + 4 * _q(c)
    at_rail = (1 - _q(0.5 / (amp * sigma))) + _q((2 * amp - 0.5) / (amp * sigma))
    got_rail = float(((rx == numeric.soft_high) | (rx == numeric.soft_low)).double().mean())
    for what, got, want, se in (
            ("mean", float(d.mean()), mean, float(d.std()) / math.sqrt(n)),
            ("second moment", float((d * d).mean()), second, float((d * d).std()) / math.sqrt(n)),
            ("share at a rail", got_rail, at_rail, math.sqrt(at_rail * (1 - at_rail) / n))):
        assert abs(got - want) <= 5 * se, (what, got, want, se)


def test_generator_and_dtype():
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    data = np.random.default_rng(3).integers(0, 256, size=(4, 16), dtype=np.uint8)
    a = channel.awgn_symbols(code, numeric, data, 2.0, torch.Generator().manual_seed(5), "cpu")
    b = channel.awgn_encode_frames(code, numeric, torch.from_numpy(data), 2.0,
                                   torch.Generator().manual_seed(5), "cpu")
    assert a.dtype == torch.int32 and a.shape == (4, code.total_symbols(16))
    assert torch.equal(a, b)
    assert int(a.min()) >= numeric.soft_low and int(a.max()) <= numeric.soft_high
    # rounding is half to even, as jnp.round
    assert torch.equal(torch.round(torch.tensor([0.5, 1.5, -0.5, 2.5])),
                       torch.tensor([0.0, 2.0, -0.0, 2.0]))


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("ebn0", [2.0, 5.0])
def test_decode_of_jax_awgn_symbols_equals_jax(ebn0, backend):
    code, jcode = P.VITERBI27, J.VITERBI27
    numeric, jnumeric = P.soft16_spec(2), J.soft16_spec(2)
    data = np.random.default_rng(int(ebn0)).integers(0, 256, size=(8, 64), dtype=np.uint8)
    syms = jchannel.awgn_symbols(jcode, jnumeric, jax.random.key(int(ebn0)), jnp.asarray(data),
                                 ebn0)
    want = np.asarray(jdecode(jcode, jnumeric, syms, 64 * 8))
    got = P.decode_symbols(code, numeric, np.array(syms), 64 * 8, backend=backend,
                           device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if ebn0 == 2.0:
        assert (want != data).any()  # the channel is noisy enough to matter


def test_awgn_example_runs_on_the_cpu(capsys):
    from ka9q_viterbi_comparison_tpu_torch.examples import decode_awgn

    decode_awgn.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "coded BER" in out and "on cpu" in out
