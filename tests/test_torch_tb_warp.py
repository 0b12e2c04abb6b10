"""The host tables of the state-order K <= 9 warp kernel, and its step replayed.

``acs_tb_warp_kernel`` (``csrc/viterbi_small.cu``) serves ``acs_update_tb``
and ``acs_update_tb2`` for K <= 9: a warp a frame, new state ``n`` at lane
``n % 32`` of register ``n // 32``, its two predecessors fetched by shuffles
from the lanes of ``kernels.warp_lane_table`` and the registers of
``source_registers``, its penalties looked up by the patterns of
the same table, each step's canonical words the ballots of its registers.

Here that table is held against the JAX package's ``transition_tables``
(``ops/branch.py``) from first principles, and the kernel's step is replayed
from it in plain torch (lanes as a tensor axis, a shuffle as a gather over
it, a ballot as a pack of the lanes' bits) and held bit-equal to the port's
plain versions ``acs_update_tb_ref`` / ``acs_update_tb2_ref`` for the four
K <= 9 reference codes, a K=5 code, a K=3 code, a K=2 code and a code that
does not tap both register ends, and at two shapes to the JAX ``acs_update_tb`` in
interpret mode.  Tolerance: exact equality (integer arithmetic)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import branch as jbranch
from ka9q_viterbi_comparison_tpu.ops.pallas import kernels as jk
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import kernels as pk, kernels2 as pk2

K2 = J.CodeSpec("k2r2", 2, 2, (0o3, 0o1))
K3 = J.CodeSpec("k3r2", 3, 2, (0o7, 0o5))
K5 = J.CodeSpec("k5r2", 5, 2, (0o23, 0o35))
ONE_END = J.CodeSpec("k7oneend", 7, 2, (0o155, 0o056))  # 0o056 taps neither end
CODES = [J.VITERBI27, J.VITERBI47, J.VITERBI29, J.VITERBI49, K5, K3, K2, ONE_END]
ids = lambda c: c.name  # noqa: E731


def ported(jc, spec="soft8_spec"):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(getattr(J, spec)(jc.R))))


def source_registers(code):
    """The registers from which register ``r`` of the warp form shuffles its
    low and high predecessors, as the kernel's template computes them:
    ``r >> 1`` and ``(r >> 1) + NR/2``, register 0 for both below 64 states."""
    nr = max(1, code.num_states // 32)
    r = np.arange(nr)
    return (r >> 1, (r >> 1) + nr // 2) if nr > 1 else (r, r)


def replay(code, numeric, metrics_sb, symbols_trb, t_real):
    """The warp kernel's sweep in plain torch: ``(metrics [S, B], words
    [Tp, W, B])``, words past ``t_real`` zero."""
    S, B = metrics_sb.shape
    R, NR = code.R, max(1, S // 32)
    lanes = torch.arange(32)
    e = torch.from_numpy(pk.warp_lane_table(code).view(np.uint32).astype(np.int64)).reshape(NR, 32)
    ao, ap, slo, shi = e & 0xFF, (e >> 8) & 0xFF, (e >> 16) & 0xFF, e >> 24
    lo_reg, hi_reg = (torch.from_numpy(r) for r in source_registers(code))
    live = (32 * torch.arange(NR)[:, None] + lanes[None, :]) < S             # [NR, 32]
    comp = pk.complement_form(code)
    csum = R * (numeric.soft_high - numeric.soft_low)
    m = torch.zeros((NR, 32, B), dtype=torch.int64)
    m.view(NR * 32, B)[:S] = metrics_sb.to(torch.int64)
    x = torch.arange(1 << R)
    bits = ((x[:, None] >> torch.arange(R)[None, :]) & 1)                   # [2^R, R]
    dec = torch.zeros((symbols_trb.shape[0], code.decision_words, B), dtype=torch.int32)
    weights = (torch.ones(32, dtype=torch.int64) << lanes)[None, :, None]
    for t in range(t_real):
        y = symbols_trb[t].to(torch.int64)                                    # [R, B]
        base = (y - numeric.soft_low).sum(0)                                  # [B]
        coef = (numeric.soft_high + numeric.soft_low) - 2 * y                 # [R, B]
        table = base[None, :] + bits @ coef                                   # [2^R, B]: P(x)
        lo = m[lo_reg[:, None], slo]                                          # shuffles
        hi = m[hi_reg[:, None], shi]
        po = table[ao]
        c_lo = lo + po
        c_hi = hi - po + csum if comp else hi + table[ap]
        d = (c_hi < c_lo) & live[:, :, None]
        m = torch.minimum(c_lo, c_hi)
        words = ((d.to(torch.int64) * weights).sum(1)) & 0xFFFFFFFF           # ballots [NR, B]
        dec[t] = torch.from_numpy(words.numpy().astype(np.uint32).view(np.int32))
    return m.reshape(NR * 32, B)[:S].to(torch.int32), dec


def random_inputs(code, numeric, B, Tp, seed):
    rng = np.random.default_rng(seed)
    sym = rng.integers(numeric.soft_low, numeric.soft_high + 1, size=(Tp, code.R, B))
    m = rng.integers(0, 60, size=(code.num_states, B))
    return torch.from_numpy(m.astype(np.int32)), torch.from_numpy(sym.astype(np.int32))


@pytest.mark.parametrize("jc", CODES, ids=ids)
def test_lane_table_from_first_principles(jc):
    """Entry ``n``: the patterns of the branches into new state ``n`` on
    input bit ``n & 1`` from predecessor half-state ``n >> 1`` (``h = 0``) and
    from ``(n >> 1) + S/2`` (``h = 1``), and the lanes that hold those two
    states; the registers that hold them are ``source_registers``."""
    pc, _ = ported(jc)
    S, R = jc.num_states, jc.R
    E = jbranch.transition_tables(jc).astype(np.int64)  # [4 (2h + b), R, S/2]
    tab = pk.warp_lane_table(pc).view(np.uint32).astype(np.int64)
    assert tab.shape == (max(S, 32),) and not tab[S:].any()
    n = np.arange(S)
    b, s2 = n & 1, n >> 1
    weights = (1 << np.arange(R))[:, None]
    np.testing.assert_array_equal(tab[:S] & 0xFF, (E[b, :, s2].T * weights).sum(0))
    np.testing.assert_array_equal((tab[:S] >> 8) & 0xFF, (E[2 + b, :, s2].T * weights).sum(0))
    lo_reg, hi_reg = source_registers(pc)
    reg = n // 32
    for pred, lanes, regs in ((s2, (tab[:S] >> 16) & 0xFF, lo_reg),
                              (s2 + S // 2, tab[:S] >> 24, hi_reg)):
        np.testing.assert_array_equal(32 * regs[reg] + lanes, pred)


@pytest.mark.parametrize("jc", CODES, ids=ids)
def test_complement_form_pays_the_high_branch(jc):
    """Where every polynomial taps both ends, the high branch's pattern is
    the low one's complement, so its penalty is ``R * (high - low)`` minus
    the low one's: what the kernel computes with ``COMP``."""
    pc, pn = ported(jc)
    tab = pk.warp_lane_table(pc).view(np.uint32).astype(np.int64)[:jc.num_states]
    full = (1 << jc.R) - 1
    assert pk.complement_form(pc) == bool(((tab >> 8) & 0xFF == (tab & 0xFF) ^ full).all())
    assert pk.complement_form(pc) == (jc not in (ONE_END, K2))  # K2's 0o1 taps one end
    y = np.random.default_rng(jc.K).integers(pn.soft_low, pn.soft_high + 1, size=jc.R)
    P = [sum(y[r] - pn.soft_low + ((x >> r) & 1) * (pn.soft_high + pn.soft_low - 2 * y[r])
             for r in range(jc.R)) for x in range(1 << jc.R)]
    assert all(P[x] + P[x ^ full] == jc.R * (pn.soft_high - pn.soft_low) for x in range(full + 1))


REPLAY_CASES = [(jc, depth) for jc in CODES for depth in (1, 2) if depth == 1 or jc.K >= 3]


@pytest.mark.parametrize("jc,depth", REPLAY_CASES,
                         ids=[f"{jc.name}-depth{d}" for jc, d in REPLAY_CASES])
def test_replay_equals_plain_version(jc, depth):
    """The replayed warp sweep against the plain version of the entry point
    that launches it (``acs_update_tb2`` serves K >= 3), at a ``t_real`` that
    is odd and not a multiple of 32, over two frames."""
    pc, pn = ported(jc, "soft16_spec" if jc is J.VITERBI29 else "soft8_spec")
    m, sym = random_inputs(pc, pn, 2, 48, seed=jc.K * 10 + depth)
    t_real = 45
    ref = pk.acs_update_tb_ref if depth == 1 else pk2.acs_update_tb2_ref
    rm, rd = ref(pc, pn, m, sym, t_real)
    gm, gd = replay(pc, pn, m, sym, t_real)
    assert torch.equal(gm, rm) and torch.equal(gd, rd)


@pytest.mark.parametrize("jc,spec,B,T", [(J.VITERBI27, "soft8_spec", 4, 70),
                                         (J.VITERBI29, "soft16_spec", 3, 41)],
                         ids=["viterbi27-soft8", "viterbi29-soft16"])
def test_replay_equals_pallas(jc, spec, B, T):
    """The replayed sweep against the JAX ``acs_update_tb`` (interpret mode)
    on frames padded to its time block: metrics and words."""
    jn = getattr(J, spec)(jc.R)
    pc, pn = ported(jc, spec)
    TB = jk.pick_time_block(jc, B)
    Tp = -(-T // TB) * TB
    m, sym = random_inputs(pc, pn, B, Tp, seed=71)
    jm, jd = jk.acs_update_tb(jc, jn, jnp.asarray(m.numpy()), jnp.asarray(sym.numpy()), T, True)
    gm, gd = replay(pc, pn, m, sym, T)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(gd[:T].numpy().view(np.uint32), np.asarray(jd)[:T])


@pytest.mark.parametrize("K,R", [(k, r) for k in range(2, 10) for r in (1, 4, 8)])
def test_smem_within_the_launch_limits(K, R):
    """Both entry points' K <= 9 launch (two warps a block) takes the same
    shared memory, under the launcher's cap at every R."""
    pc = code_from_fields(f"k{K}r{R}", K, R, tuple([(1 << K) - 1] * R))
    want = pk.TB_WARPS * 4 * (2 * (1 << R) * 33 + 2 * 32 * R)
    assert pk.acs_smem_bytes(pc) == want
    if K >= 3:
        assert pk2.tb2_smem_bytes(pc) == want
    assert want <= 220 * 1024
