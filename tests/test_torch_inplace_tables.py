"""The host tables of the in-place CUDA kernels.

The kernels do no rotation and no transition-table lookup of their own: the
penalty pattern of every butterfly and position at every rotation phase comes
from numpy tables built in ``ops/cuda/inplace.py``.  Each is held bit-equal to
the JAX package's ``rotating_tables_jnp`` / ``transition_tables``
(``ops/branch.py``) and ``rot_perm`` (``ops/pallas/inplace.py``), for the six
reference codes, a K=5 code and a code that does not tap both register ends.
The launch geometry the Python side mirrors is checked against its own
limits.  No Pallas kernel runs here.  Tolerance: exact equality."""

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import branch as jbranch
from ka9q_viterbi_comparison_tpu.ops.pallas import inplace as jip
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields
from ka9q_viterbi_comparison_tpu_torch.configs import soft8_spec
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, inplace as pip

K5 = J.CodeSpec("k5r2", 5, 2, (0o23, 0o35))
ONE_END = J.CodeSpec("k7oneend", 7, 2, (0o155, 0o056))  # 0o056 taps neither end
SMALL = [J.VITERBI27, J.VITERBI47, J.VITERBI29, J.VITERBI49, J.VITERBI615, K5, ONE_END]
ALL = SMALL + [J.VITERBI224]
ids = lambda c: c.name  # noqa: E731


def ported(jc):
    return code_from_fields(jc.name, jc.K, jc.R, jc.polys)


def phases_of(jc):
    """Every phase of a small trellis; three of ICE's 23 (4M pairs each)."""
    return range(jc.K - 1) if jc.K <= 15 else (0, 5, jc.K - 2)


def unpack(table, R):
    """``[..., n]`` packed int32 -> ``[4, R, ..., n]`` bits."""
    t = table.astype(np.int64)
    return np.stack([np.stack([(t >> (8 * x + r)) & 1 for r in range(R)]) for x in range(4)])


@pytest.mark.parametrize("jc", ALL, ids=ids)
def test_pair_table_matches_rotating_tables(jc):
    pc = ported(jc)
    for c in phases_of(jc):
        want = np.asarray(jbranch.rotating_tables_jnp(jc, c))  # [4, R, S/2]
        got = unpack(pip.pair_table(pc, c), jc.R)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jc", SMALL, ids=ids)
def test_pair_tables_are_transition_tables_through_rot_perm(jc):
    """Butterfly ``i`` of phase ``c`` sits at the low position ``q`` (``i`` with
    a zero at bit ``j``), which holds predecessor half-state ``rot_perm(c)[q]``."""
    pc = ported(jc)
    E = jbranch.transition_tables(jc)  # [4, R, S/2]
    tabs = pip.pair_tables(pc)
    assert tabs.shape == (jc.K - 1, jc.num_states // 2) and tabs.dtype == np.int32
    i = np.arange(jc.num_states // 2)
    for c in range(jc.K - 1):
        j = (jc.K - 2 - c) % (jc.K - 1)
        q = ((i >> j) << (j + 1)) | (i & ((1 << j) - 1))
        s2 = jip.rot_perm(jc, c)[q]
        assert s2.max() < jc.num_states // 2
        np.testing.assert_array_equal(unpack(tabs[c], jc.R), E[:, :, s2])


@pytest.mark.parametrize("jc", SMALL, ids=ids)
def test_position_tables_from_first_principles(jc):
    """Position ``p`` at phase ``c`` becomes new state ``rot_perm(c+1)[p]``;
    its own old metric is that of state ``rot_perm(c)[p]``, one of the new
    state's two predecessors, and the partner's the other."""
    pc = ported(jc)
    S, K, R = jc.num_states, jc.K, jc.R
    E = jbranch.transition_tables(jc).astype(np.int64)  # [4, R, S/2]
    pos = pip.position_tables(pc)
    assert pos.shape == (K - 1, max(S, 32)) and pos.dtype == np.int32
    assert not pos[:, S:].any()
    weights = (1 << np.arange(R))[:, None]
    for c in range(K - 1):
        new = jip.rot_perm(jc, c + 1)[:S]
        old = jip.rot_perm(jc, c)[:S]
        b, s2 = new & 1, new >> 1
        h = old >> (K - 2)
        np.testing.assert_array_equal(old & (S // 2 - 1), s2)  # really a predecessor
        own = (E[2 * h + b, :, s2].T * weights).sum(0)
        partner = (E[2 * (1 - h) + b, :, s2].T * weights).sum(0)
        np.testing.assert_array_equal(pos[c, :S] & 0xFF, own)
        np.testing.assert_array_equal(pos[c, :S] >> 8, partner)
        # the partner position holds the other predecessor
        j = (K - 2 - c) % (K - 1)
        np.testing.assert_array_equal(old ^ (S // 2), jip.rot_perm(jc, c)[np.arange(S) ^ (1 << j)])


@pytest.mark.parametrize("jc", ALL, ids=ids)
def test_complement_form_is_both_ends_tapped(jc):
    pc = ported(jc)
    both = all((p & 1) and (p >> (jc.K - 1)) & 1 for p in jc.abs_polys())
    assert pip.complement_form(pc) == both
    assert pip.complement_form(pc) == (jc is not ONE_END)
    E = jbranch.transition_tables(jc)
    factored = (np.array_equal(E[1], 1 - E[0]) and np.array_equal(E[2], 1 - E[0])
                and np.array_equal(E[3], E[0]))
    assert pip.complement_form(pc) == factored


@pytest.mark.parametrize("jc", SMALL, ids=ids)
def test_rot_perm_of_every_phase(jc):
    pc = ported(jc)
    for t in (0, 1, jc.K - 2, jc.K - 1, 3 * jc.K + 1):
        np.testing.assert_array_equal(pip.rot_perm(pc, t), jip.rot_perm(jc, t))
        np.testing.assert_array_equal(pip.rot_perm(pc, t, inverse=True),
                                      jip.rot_perm(jc, t, inverse=True))


@pytest.mark.parametrize("K,R", [(k, r) for k in range(2, 16) for r in (1, 2, 4, 6, 8)])
def test_geometry_within_the_launch_limits(K, R):
    pc = code_from_fields(f"k{K}r{R}", K, R, tuple([(1 << K) - 1] * R))
    wpb = pip.inplace_warps_per_block(pc)
    assert 1 <= wpb * 32 <= 1024
    if K <= 9:
        assert max(1, pc.num_states // 32) <= 8 and wpb <= 4   # a lane stores one word a step
    assert pip.inplace_smem_bytes(pc) <= pip.SMEM_CAP


@pytest.mark.parametrize("jc,want", [
    (J.VITERBI27, (4, 4 * 4 * (2 * 30 * 5 + 128))),
    (J.VITERBI47, (4, 4 * 4 * (2 * 30 * 17 + 256))),
    (J.VITERBI29, (4, 4 * 4 * (2 * 32 * 5 + 128))),
    (J.VITERBI49, (4, 4 * 4 * (2 * 32 * 17 + 256))),
    (J.VITERBI615, (32, 4 * (16384 + 2 * 32 * 65 + 384 + 512) + 14 * 8192)),
    (J.CodeSpec("k12oneend", 12, 2, (0o6731, 0o2246)), (32, 4 * (2048 + 2 * 32 * 5 + 128 + 512))),
], ids=lambda x: getattr(x, "name", None))
def test_geometry_of_the_reference_codes(jc, want):
    pc = ported(jc)
    assert (pip.inplace_warps_per_block(pc), pip.inplace_smem_bytes(pc)) == want
    assert dispatch.fits_shared(pc, torch.device("cpu"))


@pytest.mark.parametrize("jc", [J.VITERBI27, K5, ONE_END], ids=ids)
@pytest.mark.parametrize("t0", [0, 1, 5])
def test_plain_versions_chain_blockwise(jc, t0):
    """Two halves with ``t0`` equal the whole frame, in the plain versions
    that the kernels are held against on the card."""
    pc, pn = ported(jc), soft8_spec(jc.R)
    rng = np.random.default_rng(jc.K + t0)
    T, B, T1 = 45, 3, 19
    sym = torch.from_numpy(rng.integers(pn.soft_low, pn.soft_high + 1, size=(T, jc.R, B))
                           .astype(np.int32))
    m = torch.from_numpy(rng.integers(0, 40, size=(jc.num_states, B)).astype(np.int32))
    mw, dw = pip.acs_update_inplace(pc, pn, m, sym, T, t0)
    m1, d1 = pip.acs_update_inplace(pc, pn, m, sym[:T1].contiguous(), T1, t0)
    m2, d2 = pip.acs_update_inplace(pc, pn, m1, sym[T1:].contiguous(), T - T1, t0 + T1)
    assert torch.equal(m2, mw) and torch.equal(torch.cat([d1, d2]), dw)
    end = torch.from_numpy(rng.integers(0, jc.num_states, size=(1, B)).astype(np.int32))
    pad = torch.zeros((64 - T, *dw.shape[1:]), dtype=torch.int32)
    whole = pip.chainback_inplace(pc, torch.cat([dw, pad]), end, T, t0)
    window = pip.chainback_inplace(pc, torch.cat([d2, pad]), end, T - T1, t0 + T1)
    got = np.asarray(dispatch.unpack_bit_words(whole, T))[:, T1:]
    np.testing.assert_array_equal(np.asarray(dispatch.unpack_bit_words(window, T - T1)), got)
