"""The port's encoder against the JAX package's, for all six codes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import encoder as jenc
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops import encoder as penc

CODES = [pytest.param(c, id=c.name) for c in J.STANDARD_CODES] + [
    pytest.param(J.CodeSpec("inv27", K=7, R=2, polys=(-0o155, 0o117)), id="inverted")]


@pytest.mark.parametrize("jc", CODES)
@pytest.mark.parametrize("spec", ["soft8_spec", "soft16_spec"])
def test_encode_frames_match(jc, spec):
    pc = code_from_fields(jc.name, jc.K, jc.R, jc.polys)
    jn, pn = getattr(J, spec)(jc.R), getattr(P, spec)(jc.R)
    data = np.random.default_rng(jc.K).integers(0, 256, size=(2, 8), dtype=np.uint8)
    want = np.asarray(jenc.encode_frames(jc, jn, jnp.asarray(data)))
    got = penc.encode_frames(pc, pn, torch.from_numpy(data))
    assert got.dtype == torch.int32
    assert got.shape == (2, pc.total_symbols(8))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("jc", CODES)
def test_encode_bits_match(jc):
    pc = code_from_fields(jc.name, jc.K, jc.R, jc.polys)
    bits = np.random.default_rng(1).integers(0, 2, size=(3, 20), dtype=np.uint8)
    want = np.asarray(jenc.encode_bits(jc, jnp.asarray(bits)))
    got = penc.encode_bits(pc, torch.from_numpy(bits))
    assert got.shape == (3, 20 + pc.K - 1, pc.R)
    np.testing.assert_array_equal(got.numpy(), want)
    assert penc.encoded_symbol_count(pc, 8) == jenc.encoded_symbol_count(jc, 8)
