"""The port's bit-plane radix traceback (``ops/radix_planes.py``) against the
JAX package's, on the CPU: the window plan, the tables built from random
decision words (which walk arbitrary survivor paths; bit 31 of the planes is
set in half the words), and the table walk, at both widths and both anchors;
and the tables that the depth-4 update's fields forms return, against the JAX
kernels' (interpret mode) and against the port's ``build_plane_tables`` over the words
route's words.  Tolerance: exact equality (bit operations)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs, chainback as jcb, radix_planes as jrp
from ka9q_viterbi_comparison_tpu.ops.pallas import large_k4 as jlk4
from ka9q_viterbi_comparison_tpu_torch.convert import (
    code_from_fields,
    numeric_from_fields,
    tables_from_numpy,
    words_from_numpy,
)
from ka9q_viterbi_comparison_tpu_torch.ops import chainback as pcb, radix_planes as prp
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import large_k4 as plk4

K11 = J.CodeSpec("k11test", K=11, R=2, polys=(0o2672, 0o3545))
K10 = J.CodeSpec("k10test", K=10, R=2, polys=(0o1234, 0o1571))


def ported(jc):
    return code_from_fields(jc.name, jc.K, jc.R, jc.polys)


def random_words(jc, T, B, seed=42):
    """``[B, T, W]`` uint32, every bit random."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(B, T, jc.num_states // 32), dtype=np.uint32)


def test_plane_plan_matches_jax():
    assert (prp.W_WALK, prp.MIN_N) == (jrp.W_WALK, jrp.MIN_N)
    for max_width in (4, 8):
        for T, anchor in [(87, 0), (87, 23), (64, 0), (45, 8), (96, 14), (30, 23), (23, 23)]:
            assert prp.plane_plan(T, anchor, max_width) == jrp.plane_plan(T, anchor, max_width)
    assert prp.plane_plan(87, 23) == jrp.plane_plan(87, 23)
    assert [w for _, w in prp.plane_plan(87, 23, 8)] == [8] * 8


@pytest.mark.parametrize("v", [1, 2, 4])
def test_spread_top_bits(v):
    """Every source bit set, the one that lands on bit 31 included."""
    nb = 32 >> v
    x = np.arange(1 << min(nb, 12), dtype=np.uint32) | np.uint32(1 << (nb - 1))
    want = np.asarray(jrp._spread(jnp.asarray(x), v))
    got = prp._spread(words_from_numpy(x), v).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (got >> 31).all()


@pytest.mark.parametrize("max_width", [4, 8])
@pytest.mark.parametrize("jc,T,B", [
    (K11, 87, 3),            # remainder at top
    (K11, 64, 2),            # exact multiple of 8
    (J.VITERBI615, 45, 2),   # K=15, remainder 5
    (K10, 50, 2),            # minimum supported K-1 = 9
], ids=["k11_T87", "k11_T64", "k15_T45", "k10_T50"])
def test_tables_and_walk_match_jax(jc, T, B, max_width):
    """Both anchors (0 and K-1), end states 0 and 5: every table equals the
    JAX function's, the walk's bits and final state equal the JAX table
    walk's, and the port's plain walk's."""
    pc = ported(jc)
    words = random_words(jc, T, B)
    jw_tm = jnp.asarray(words.transpose(1, 0, 2))
    pw = words_from_numpy(words)
    pw_tm = pw.transpose(0, 1)
    nbits = (T - jc.K + 1) // 8 * 8
    for anchor in (0, jc.K - 1):
        jtabs = jrp.build_plane_tables(jc, jw_tm, anchor, None, max_width)
        ptabs = prp.build_plane_tables(pc, pw_tm, anchor, None, max_width)
        assert set(ptabs) == set(jtabs) and ("f8" in ptabs) == (max_width == 8)
        for name, t in jtabs.items():
            assert ptabs[name].shape == t.shape, name
            np.testing.assert_array_equal(ptabs[name].numpy().view(np.uint32), np.asarray(t), name)
        assert (ptabs["g2"] < 0).any()  # planes with bit 31 set
        for endstate in (0, 5):
            jbits, jstate = jrp.chainback_plane_bits(jc, jw_tm, jtabs, nbits, endstate, anchor)
            bits, state = prp.chainback_plane_bits(pc, pw_tm, ptabs, nbits, endstate, anchor)
            np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
            np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
            plain, _ = pcb.chainback_bits(pc, pw, nbits, endstate)
            assert torch.equal(bits, plain)


def test_anchor_zero_reaches_the_start_state():
    """anchor=0 is the full walk, start state included; a per-frame end
    state tensor works like the scalar."""
    jc, T, B = K11, 40, 2
    pc = ported(jc)
    words = random_words(jc, T, B, seed=3)
    pw = words_from_numpy(words)
    end = torch.tensor([7, 1000], dtype=torch.int32)
    want_bits, want_state = pcb.chainback_bits(pc, pw, 16, end)
    tabs = prp.build_plane_tables(pc, pw.transpose(0, 1), 0)
    bits, state = prp.chainback_plane_bits(pc, pw.transpose(0, 1), tabs, 16, end, 0)
    assert torch.equal(bits, want_bits) and torch.equal(state, want_state)
    jbits, jstate = jcb.chainback_bits(jc, jnp.asarray(words), 16, 7)
    np.testing.assert_array_equal(bits[0].numpy(), np.asarray(jbits)[0])
    assert int(state[0]) == int(np.asarray(jstate)[0])


@pytest.mark.parametrize("width", [4, 8])
def test_table_only_walk(width):
    """The walk over ``{"f4"}`` or ``{"f8"}`` alone (no words), as the
    fields kernels' callers run it: equal to the JAX walk over the same
    tables carried across as numpy, in bits and bytes."""
    jc = K11
    pc = ported(jc)
    anchor = jc.K - 1
    T = anchor + 48
    words = random_words(jc, T, 3, seed=width)
    jtabs = jrp.build_plane_tables(jc, jnp.asarray(words.transpose(1, 0, 2)), anchor, None, width)
    name = f"f{width}"
    jonly = {name: jtabs[name]}
    ponly = tables_from_numpy({name: np.asarray(jtabs[name])})
    jbits, _ = jrp.chainback_plane_bits(jc, None, jonly, 48, 9, anchor)
    bits, _ = prp.chainback_plane_bits(pc, None, ponly, 48, 9, anchor)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(prp.chainback_planes(pc, None, ponly, 48, 9, anchor).numpy(),
                                  np.asarray(jrp.chainback_planes(jc, None, jonly, 48, 9, anchor)))
    with pytest.raises(ValueError, match="anchor must be"):
        prp.chainback_plane_bits(pc, None, ponly, 48, 0, anchor + 1)


def fields_lead(jc, T, width):
    """The ``lead`` the dispatch gives each form: ``(K-1) % 4`` for f4, the
    8-aligned anchor's remainder for f8."""
    a = jc.K - 1
    if width == 4:
        return a % 4
    return (a - ((a - T % 8) % 8)) % 8


@pytest.mark.parametrize("width", [4, 8], ids=["fields", "fields8"])
@pytest.mark.parametrize("jc,spec", [(K10, "soft8_spec"), (K11, "ka9q_offset_binary_spec")],
                         ids=["k10_soft8", "k11_ob_renorm"])
def test_fields_match_jax(jc, spec, width):
    """A 10-byte frame's steps (T = 80 + K - 1) of random symbols: the table
    equals the JAX kernel's, and equals what the port's
    ``build_plane_tables`` makes of the words route's words.  With
    offset-binary symbols the block overflows int16, so the scan
    renormalises: every 11 quads of 22 (the second shift follows the last
    quad), or every 5 quad pairs of 11."""
    jn = J.ka9q_offset_binary_spec() if spec == "ka9q_offset_binary_spec" else J.soft8_spec(2)
    pc, pn = ported(jc), numeric_from_fields(**dataclasses.asdict(jn))
    T = 80 + jc.K - 1
    rn = {"soft8_spec": 0, "ka9q_offset_binary_spec": 11 if width == 4 else 5}[spec]
    assert plk4.renorm_schedule4(pc, pn, T, None, width)[1] == rn
    rng = np.random.default_rng(jc.K + width)
    sym = rng.integers(jn.soft_low, jn.soft_high + 1, size=(2, T, 2)).astype(np.int32)
    m0 = (np.asarray(jacs.init_metrics(jc, jn, 2))
          + rng.integers(2, 30, size=(2, jc.num_states))).astype(np.int32)
    lead = fields_lead(jc, T, width)
    jfn, pfn = {4: (jlk4.acs_update_large4_fields, plk4.acs_update_large4_fields),
                8: (jlk4.acs_update_large4_fields8, plk4.acs_update_large4_fields8)}[width]
    want = jfn(jc, jn, jnp.asarray(m0), jnp.asarray(sym), lead, True)
    got = pfn(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym), lead)
    assert got[1].shape == ((T - lead) // width, width, 2, jc.num_states // 32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if rn and ((T - lead) // width) % rn == 0:
        assert (got[0].amin(dim=1) == 0).all()  # the shift after the last quad landed
    # Against the words route: same metrics + offset, same table.
    m_w, words, off_w = plk4.acs_update_large4(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym),
                                               time_major=True)
    assert torch.equal(m_w + off_w[:, None], got[0] + got[2][:, None])
    tabs = prp.build_plane_tables(pc, words, lead, None, width)
    assert torch.equal(tabs[f"f{width}"], got[1])


def test_rejections():
    small = code_from_fields("k9", 9, 2, (0x1AF, 0x11D))
    with pytest.raises(ValueError, match="K-1 >= 9"):
        prp.build_plane_tables(small, torch.zeros((16, 1, 8), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="max_width"):
        prp.build_plane_tables(ported(K10), torch.zeros((16, 1, 16), dtype=torch.int32), 0, None, 2)
    with pytest.raises(ValueError, match="unsupported spread"):
        prp._spread(torch.zeros(1, dtype=torch.int32), 3)
