"""The port's configs, branch tables and bit utilities against the JAX package.

Exact equality throughout: every quantity is an integer."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import branch as jbranch
from ka9q_viterbi_comparison_tpu.utils import bits as jbits
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops import branch as pbranch
from ka9q_viterbi_comparison_tpu_torch.utils import bits as pbits

CODES = [pytest.param(c, id=c.name) for c in J.STANDARD_CODES]
SPECS = ["ka9q_offset_binary_spec", "soft16_spec", "soft8_spec", "hard8_spec"]


def port_code(jc):
    return code_from_fields(jc.name, jc.K, jc.R, jc.polys)


def spec_pair(name, R):
    jfn, pfn = getattr(J, name), getattr(P, name)
    if name == "ka9q_offset_binary_spec":
        return jfn(), pfn()
    return jfn(R), pfn(R)


@pytest.mark.parametrize("jc", CODES)
def test_code_fields_match(jc):
    pc = getattr(P, jc.name.upper())
    assert (pc.name, pc.K, pc.R, pc.polys) == (jc.name, jc.K, jc.R, jc.polys)
    assert pc == port_code(jc)
    assert (pc.num_states, pc.decision_words, pc.tail_bits) == (
        jc.num_states, jc.decision_words, jc.tail_bits)
    n = P.BENCH_FRAME_BYTES[pc.name]
    assert n == J.BENCH_FRAME_BYTES[jc.name]
    assert pc.transmit_bits(n) == jc.transmit_bits(n)
    assert pc.total_symbols(n) == jc.total_symbols(n)
    np.testing.assert_array_equal(pc.expected_bits_table(), jc.expected_bits_table())


def test_standard_codes_order():
    assert [c.name for c in P.STANDARD_CODES] == [c.name for c in J.STANDARD_CODES]


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("R", [2, 4, 6])
def test_numeric_specs_match(name, R):
    jn, pn = spec_pair(name, R)
    assert dataclasses.asdict(pn) == dataclasses.asdict(jn)
    assert numeric_from_fields(**dataclasses.asdict(jn)) == pn
    assert pn.max_branch_error(R) == jn.max_branch_error(R)


def _parity_identity(code):
    """``transition_tables_jnp``'s decomposition, in numpy:
    parity(((s2<<1)|b|(h<<(K-1))) & p) = parity(s2 & (p>>1)) ^ (b & p) ^ (h & p>>(K-1))."""
    K, half = code.K, code.num_states // 2
    s2 = np.arange(half, dtype=np.int64)
    out = np.empty((4, code.R, half), np.uint8)
    for h in (0, 1):
        for b in (0, 1):
            for r, (p, inv) in enumerate(zip(code.abs_polys(), code.inversions())):
                x = s2 & (p >> 1)
                for shift in (16, 8, 4, 2, 1):
                    x = x ^ (x >> shift)
                out[h * 2 + b, r] = (x & 1) ^ ((b & p & 1) ^ (h & (p >> (K - 1)) & 1) ^ int(inv))
    return out


@pytest.mark.parametrize("jc", CODES)
def test_transition_tables(jc):
    pc = port_code(jc)
    table = pbranch.transition_tables(pc)
    np.testing.assert_array_equal(table, jbranch.transition_tables(jc))
    np.testing.assert_array_equal(table, _parity_identity(pc))
    if jc.K <= 15:  # the K=24 table is 128 MiB of int32 on the JAX side
        np.testing.assert_array_equal(table, np.asarray(jbranch.transition_tables_jnp(jc)))


@pytest.mark.parametrize("jc", CODES[:5])
def test_packed_transition_table_unpacks(jc):
    pc = port_code(jc)
    packed = pbranch.packed_transition_table(pc).astype(np.int64)
    shifts = (8 * np.arange(4)[:, None] + np.arange(pc.R)[None, :])[..., None]
    np.testing.assert_array_equal((packed[None, None] >> shifts) & 1,
                                  pbranch.transition_tables(pc))


def test_inverted_polynomial_tables():
    jc = J.CodeSpec("inv27", K=7, R=2, polys=(-0o155, 0o117))
    pc = port_code(jc)
    np.testing.assert_array_equal(pbranch.transition_tables(pc), jbranch.transition_tables(jc))
    np.testing.assert_array_equal(pbranch.transition_tables(pc), _parity_identity(pc))


@pytest.mark.parametrize("name", SPECS)
def test_penalty_base_and_coef(name):
    jn, pn = spec_pair(name, 4)
    sym = np.random.default_rng(3).integers(jn.soft_low, jn.soft_high + 1, size=(3, 5, 4),
                                            dtype=np.int32)
    jb, jcoef = jbranch.penalty_base_and_coef(jn, jnp.asarray(sym))
    pb, pcoef = pbranch.penalty_base_and_coef(pn, torch.from_numpy(sym))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pcoef.numpy(), np.asarray(jcoef))


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("jc", CODES)
def test_branch_penalties(jc, name):
    jn, pn = spec_pair(name, jc.R)
    shape = (1, 2, jc.R) if jc.K > 15 else (2, 6, jc.R)  # K=24: 4M pairs a step
    sym = np.random.default_rng(jc.K).integers(jn.soft_low, jn.soft_high + 1, size=shape,
                                               dtype=np.int32)
    want = np.asarray(jbranch.branch_penalties(jc, jn, jnp.asarray(sym)))
    got = pbranch.branch_penalties(port_code(jc), pn, torch.from_numpy(sym)).numpy()
    np.testing.assert_array_equal(got, want)


def test_bits_match():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=(3, 12), dtype=np.uint8)
    pbits_ = pbits.bytes_to_bits(torch.from_numpy(data))
    np.testing.assert_array_equal(pbits_.numpy(), np.asarray(jbits.bytes_to_bits(jnp.asarray(data))))
    np.testing.assert_array_equal(pbits.bits_to_bytes(pbits_).numpy(), data)
    np.testing.assert_array_equal(
        pbits.bits_to_bytes(pbits_).numpy(),
        np.asarray(jbits.bits_to_bytes(jnp.asarray(pbits_.numpy()))))
    words = pbits.pack_bits_to_words(pbits_)  # 96 bits -> 3 words, top bits set
    np.testing.assert_array_equal(
        words.numpy().view(np.uint32),
        np.asarray(jbits.pack_bits_to_words(jnp.asarray(pbits_.numpy()))))
    other = data ^ np.uint8(0x81)
    assert pbits.count_bit_errors(torch.from_numpy(other), data) == \
        jbits.count_bit_errors(other, data) == 2 * data.size
    assert pbits.bit_error_rate(other, data) == jbits.bit_error_rate(other, data)


def test_bits_reject_ragged():
    with pytest.raises(ValueError):
        pbits.bits_to_bytes(torch.zeros(7, dtype=torch.uint8))
    with pytest.raises(ValueError):
        pbits.pack_bits_to_words(torch.zeros(33, dtype=torch.uint8))
