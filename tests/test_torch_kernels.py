"""The four kernels of the port's first slice.

On the CPU, each plain version (``*_ref``, which the wrapper runs for CPU
tensors) is held word for word against its Pallas function in interpret
mode, on noisy soft8 and soft16 symbols and the JAX-padded shapes.  Tests
marked ``cuda`` hold each CUDA kernel against its plain version and skip
where there is no card.  Tolerance: exact equality (integer arithmetic)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import inplace as jip, kernels as jk
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, inplace as pip, kernels as pk

SPECS = [pytest.param("soft8_spec", 4, id="soft8"), pytest.param("soft16_spec", 160, id="soft16")]


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def inputs(jc, jn, B, n_bytes, noise, seed):
    """Noisy symbols ``[T, R, B]`` and metrics ``[S, B]`` (the reset metrics
    plus a random spread, so every rotation phase moves real values)."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    sym = np.clip(sym + rng.integers(-noise, noise + 1, size=sym.shape), jn.soft_low, jn.soft_high)
    m0 = np.asarray(jacs.init_metrics(jc, jn, B)).T + rng.integers(0, 40, size=(jc.num_states, B))
    return (np.ascontiguousarray(sym.transpose(1, 2, 0), dtype=np.int32),
            np.ascontiguousarray(m0, dtype=np.int32))


def pad_time(s_trb, Tp):
    out = np.zeros((Tp,) + s_trb.shape[1:], np.int32)
    out[: s_trb.shape[0]] = s_trb
    return out


def words_u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("spec,noise", SPECS)
@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI29], ids=["viterbi27", "viterbi29"])
def test_acs_update_tb_ref_matches_pallas(jc, spec, noise):
    jn = getattr(J, spec)(jc.R)
    pc, pn = ported(jc, jn)
    B = 4
    s, m0 = inputs(jc, jn, B, 8, noise, seed=jc.K)
    T = s.shape[0]
    Tp = -(-T // jk.pick_time_block(jc, B)) * jk.pick_time_block(jc, B)
    s = pad_time(s, Tp)
    jm, jd = jk.acs_update_tb(jc, jn, jnp.asarray(m0), jnp.asarray(s), T, True)
    pm, pd = pk.acs_update_tb(pc, pn, torch.from_numpy(m0), torch.from_numpy(s), T)
    assert pd.shape == (Tp, jc.decision_words, B)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(words_u32(pd)[:T], np.asarray(jd)[:T])


@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI29], ids=["viterbi27", "viterbi29"])
def test_chainback_tb_ref_matches_pallas(jc):
    jn = J.soft8_spec(jc.R)
    B = 4
    s, m0 = inputs(jc, jn, B, 8, 4, seed=3)
    T = s.shape[0]
    Tp = -(-T // jk.pick_time_block(jc, B)) * jk.pick_time_block(jc, B)
    _, jd = jk.acs_update_tb(jc, jn, jnp.asarray(m0), jnp.asarray(pad_time(s, Tp)), T, True)
    end = np.random.default_rng(4).integers(0, jc.num_states, size=(1, B)).astype(np.int32)
    want = np.asarray(jk.chainback_tb(jc, jd, jnp.asarray(end), T, True))
    got = pk.chainback_tb(ported(jc, jn)[0], torch.from_numpy(np.array(jd).view(np.int32)),
                          torch.from_numpy(end), T)
    nw = -(-T // 32)
    assert got.shape == (Tp // 32, B)
    np.testing.assert_array_equal(words_u32(got)[:nw], want[:nw])


@pytest.mark.parametrize("t0", [0, 1, 5, 7])
@pytest.mark.parametrize("spec,noise", SPECS)
def test_acs_update_inplace_ref_matches_pallas(spec, noise, t0):
    jc = J.VITERBI27
    jn = getattr(J, spec)(2)
    pc, pn = ported(jc, jn)
    B = 4
    s, m0 = inputs(jc, jn, B, 8, noise, seed=10 + t0)
    T = s.shape[0]
    s = pad_time(s, jip.pad_time_inplace(jc, T, B))
    m_pos = m0[jip.rot_perm(jc, t0)]
    jm, jd = jip.acs_update_inplace(jc, jn, jnp.asarray(m_pos), jnp.asarray(s), T, t0, True)
    pm, pd = pip.acs_update_inplace(pc, pn, torch.from_numpy(m_pos), torch.from_numpy(s), T, t0)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(words_u32(pd)[:T], np.asarray(jd)[:T])


def test_acs_update_inplace_ref_k9():
    jc, jn = J.VITERBI29, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    s, m0 = inputs(jc, jn, 3, 4, 4, seed=21)
    T = s.shape[0]
    s = pad_time(s, jip.pad_time_inplace(jc, T, 3))
    m_pos = m0[jip.rot_perm(jc, 3)]
    jm, jd = jip.acs_update_inplace(jc, jn, jnp.asarray(m_pos), jnp.asarray(s), T, 3, True)
    pm, pd = pip.acs_update_inplace(pc, pn, torch.from_numpy(m_pos), torch.from_numpy(s), T, 3)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(words_u32(pd)[:T], np.asarray(jd)[:T])


@pytest.mark.parametrize("t0", [0, 1, 5, 7])
def test_chainback_inplace_ref_matches_pallas(t0):
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    B = 4
    s, m0 = inputs(jc, jn, B, 8, 4, seed=30 + t0)
    T = s.shape[0]
    Tp = jip.pad_time_inplace(jc, T, B)
    _, jd = jip.acs_update_inplace(jc, jn, jnp.asarray(m0[jip.rot_perm(jc, t0)]),
                                   jnp.asarray(pad_time(s, Tp)), T, t0, True)
    jd = jd[: -(-T // jip.CB_TB) * jip.CB_TB]
    end = np.random.default_rng(t0).integers(0, jc.num_states, size=(1, B)).astype(np.int32)
    want = np.asarray(jip.chainback_inplace(jc, jd, jnp.asarray(end), T, True, t0))
    got = pip.chainback_inplace(ported(jc, jn)[0], torch.from_numpy(np.array(jd).view(np.int32)),
                                torch.from_numpy(end), T, t0)
    nw = -(-T // 32)
    np.testing.assert_array_equal(words_u32(got)[:nw], want[:nw])


def test_rot_perm_matches_and_inverts():
    jc = J.VITERBI27
    pc = ported(jc, J.soft8_spec(2))[0]
    for t in range(8):
        fwd, inv = pip.rot_perm(pc, t), pip.rot_perm(pc, t, inverse=True)
        np.testing.assert_array_equal(fwd, jip.rot_perm(jc, t))
        np.testing.assert_array_equal(inv, jip.rot_perm(jc, t, inverse=True))
        np.testing.assert_array_equal(fwd[inv], np.arange(pc.num_states))


def test_smem_budget_formula():
    """One K=7 state-order block (the warp form): two warps, each with two
    penalty tables of 2^R columns of 33 words and two stages of symbols; a
    K=10 block of the block form: two metric buffers, the table, 32 staged
    steps of symbols and two steps of decision bytes.  One K=7 in-place block
    at B=512: four warps of one frame, each with two penalty tables of 30
    rows of 2^R + 1 words and two stages of symbols; Cassini: a frame's
    metrics, two tables of 32 rows of 65 words, two stages of symbols and the
    pattern bytes of its 14 phases."""
    pc = ported(J.VITERBI27, J.soft8_spec(2))[0]
    assert pk.acs_smem_bytes(pc) == 2 * 4 * (2 * 4 * 33 + 2 * 32 * 2)
    k10 = code_from_fields("k10r2", 10, 2, (0o1167, 0o1546))
    assert pk.acs_smem_bytes(k10) == 4 * (1024 + 256 + 64) + 2 * 16 * 32
    assert pip.inplace_warps_per_block(pc) == 4
    assert pip.inplace_smem_bytes(pc) == 4 * 4 * (2 * 30 * 5 + 2 * 32 * 2)
    cas = ported(J.VITERBI615, J.soft8_spec(6))[0]
    assert pip.inplace_smem_bytes(cas) == 4 * (16384 + 2 * 32 * 65 + 2 * 32 * 6 + 512) + 14 * 8192


def test_kernel_checks_refuse_cpu_and_wrong_inputs():
    t = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_cuda_int32("x", t, (4, 2))
    with pytest.raises(ValueError, match="t_real"):
        pk.acs_update_tb_ref(ported(J.VITERBI27, J.soft8_spec(2))[0], J.soft8_spec(2),
                             torch.zeros((64, 2), dtype=torch.int32),
                             torch.zeros((8, 2, 2), dtype=torch.int32), 9)


# -- on the card: each CUDA kernel against its plain version ---------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_inputs(B=130, n_bytes=24, seed=7):
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    s, m0 = inputs(jc, jn, B, n_bytes, 4, seed)
    pc, pn = ported(jc, jn)
    return pc, pn, torch.from_numpy(s).cuda(), torch.from_numpy(m0).cuda(), s.shape[0]


@pytest.mark.cuda
def test_cuda_acs_update_tb(cuda_device):
    pc, pn, s, m0, T = _card_inputs()
    km, kd = pk.acs_update_tb(pc, pn, m0, s, T)
    rm, rd = pk.acs_update_tb_ref(pc, pn, m0, s, T)
    assert torch.equal(km, rm) and torch.equal(kd[:T], rd[:T])
    assert _build.LAUNCHES["acs_update_tb"] > 0


@pytest.mark.cuda
def test_cuda_chainback_tb(cuda_device):
    pc, pn, s, m0, T = _card_inputs(seed=8)
    _, d = pk.acs_update_tb(pc, pn, m0, s, T)
    end = torch.randint(0, 64, (1, s.shape[2]), dtype=torch.int32, device="cuda")
    nw = -(-T // 32)
    assert torch.equal(pk.chainback_tb(pc, d, end, T)[:nw], pk.chainback_tb_ref(pc, d, end, T)[:nw])


@pytest.mark.cuda
@pytest.mark.parametrize("t0", [0, 1, 5, 7])
def test_cuda_acs_update_inplace(cuda_device, t0):
    pc, pn, s, m0, T = _card_inputs(seed=9)
    km, kd = pip.acs_update_inplace(pc, pn, m0, s, T, t0)
    rm, rd = pip.acs_update_inplace_ref(pc, pn, m0, s, T, t0)
    assert torch.equal(km, rm) and torch.equal(kd[:T], rd[:T])


@pytest.mark.cuda
@pytest.mark.parametrize("t0", [0, 1, 5, 7])
def test_cuda_chainback_inplace(cuda_device, t0):
    pc, pn, s, m0, T = _card_inputs(seed=10)
    _, d = pip.acs_update_inplace(pc, pn, m0, s, T, t0)
    end = torch.randint(0, 64, (1, s.shape[2]), dtype=torch.int32, device="cuda")
    nw = -(-T // 32)
    assert torch.equal(pip.chainback_inplace(pc, d, end, T, t0)[:nw],
                       pip.chainback_inplace_ref(pc, d, end, T, t0)[:nw])


# The forms of the in-place ACS kernel (a warp a frame up to K=9, with one or
# more frames a warp; a block a frame above; complement and generic penalty
# look-up) and of the traceback kernel (staged, or candidate fetches from
# device memory), on random symbols and random entry metrics.
FORM_CASES = [
    # K, R, polys, spec, B, T, t_real, t0
    pytest.param(9, 2, J.VITERBI29.polys, "soft16_spec", 512, 700, 700, 3, id="k9-soft16-B512"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 513, 320, 299, 0, id="k7-B513-t0=0"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 513, 320, 299, 1, id="k7-B513-t0=1"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 513, 320, 299, 5, id="k7-B513-t0=K-2"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 513, 320, 299, 6, id="k7-B513-t0=K-1"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 33, 64, 31, 4, id="k7-B33-t_real<32"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 9000, 96, 77, 2, id="k7-B9000"),
    pytest.param(7, 4, J.VITERBI47.polys, "soft8_spec", 9200, 96, 96, 1, id="k7r4-B9200"),
    pytest.param(3, 2, (0o7, 0o5), "soft8_spec", 33, 100, 99, 1, id="k3"),
    pytest.param(5, 2, (0o23, 0o35), "soft8_spec", 9100, 70, 45, 3, id="k5-B9100"),
    pytest.param(6, 2, (0o53, 0o75), "soft8_spec", 33, 100, 100, 4, id="k6"),
    pytest.param(11, 2, (0o3345, 0o2671), "soft8_spec", 33, 200, 199, 9, id="k11"),
    pytest.param(13, 1, (0o16731,), "soft8_spec", 9, 150, 131, 12, id="k13r1"),
    pytest.param(7, 2, (0o155, 0o056), "soft8_spec", 130, 150, 149, 5, id="k7-one-end"),
    pytest.param(10, 2, (0o1167, 0o0546), "soft8_spec", 17, 150, 141, 8, id="k10-one-end"),
]


def _form_inputs(K, R, polys, spec, B, T, seed=11):
    from ka9q_viterbi_comparison_tpu_torch import configs as pcfg
    pc = code_from_fields(f"k{K}r{R}", K, R, tuple(polys))
    pn = getattr(pcfg, spec)(R)
    rng = np.random.default_rng(seed)
    sym = rng.integers(pn.soft_low, pn.soft_high + 1, size=(T, R, B)).astype(np.int32)
    m = rng.integers(0, 60, size=(pc.num_states, B)).astype(np.int32)
    end = rng.integers(0, pc.num_states, size=(1, B)).astype(np.int32)
    return pc, pn, torch.from_numpy(sym).cuda(), torch.from_numpy(m).cuda(), \
        torch.from_numpy(end).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,polys,spec,B,T,t_real,t0", FORM_CASES)
def test_cuda_inplace_forms(cuda_device, K, R, polys, spec, B, T, t_real, t0):
    pc, pn, sym, m, end = _form_inputs(K, R, polys, spec, B, T)
    km, kd = pip.acs_update_inplace(pc, pn, m, sym, t_real, t0)
    rm, rd = pip.acs_update_inplace_ref(pc, pn, m, sym, t_real, t0)
    assert torch.equal(km, rm) and torch.equal(kd[:t_real], rd[:t_real])
    nw = -(-t_real // 32)
    assert torch.equal(pip.chainback_inplace(pc, kd, end, t_real, t0)[:nw],
                       pip.chainback_inplace_ref(pc, rd, end, t_real, t0)[:nw])
    assert torch.equal(pk.chainback_tb(pc, kd, end, t_real)[:nw],
                       pk.chainback_tb_ref(pc, rd, end, t_real)[:nw])


@pytest.mark.cuda
@pytest.mark.parametrize("K,polys,B", [(9, J.VITERBI29.polys, 130), (11, (0o3345, 0o2671), 9)],
                         ids=["k9", "k11"])
def test_cuda_inplace_halves_equal_whole(cuda_device, K, polys, B):
    T, T1, t0 = 301, 149, 3
    pc, pn, sym, m, end = _form_inputs(K, 2, polys, "soft8_spec", B, T)
    mw, dw = pip.acs_update_inplace(pc, pn, m, sym, T, t0)
    m1, d1 = pip.acs_update_inplace(pc, pn, m, sym[:T1].contiguous(), T1, t0)
    m2, d2 = pip.acs_update_inplace(pc, pn, m1, sym[T1:].contiguous(), T - T1, t0 + T1)
    assert torch.equal(m2, mw) and torch.equal(torch.cat([d1, d2]), dw)


@pytest.mark.cuda
def test_cuda_launch_geometry_is_what_python_says(cuda_device):
    fns = _build.library()
    for jc in (J.VITERBI27, J.VITERBI47, J.VITERBI29, J.VITERBI615):
        pc = code_from_fields(jc.name, jc.K, jc.R, jc.polys)
        assert fns["viterbi_acs_inplace_smem"](pc.K, pc.R, int(pip.complement_form(pc))) \
            == pip.inplace_smem_bytes(pc)


# The state-order ACS's forms (a warp a frame up to K=9, the block form
# above; the complement and the generic penalty look-up) through both entry
# points, on random symbols and random entry metrics: K=2..10, R=1..6,
# ``t_real`` odd, below 32 and not a multiple of 32, batches of 1, 33 and 130
# that do not fill a block's two warps.
TB_FORM_CASES = [
    # K, R, polys, spec, B, T, t_real
    pytest.param(2, 2, (0o3, 0o1), "soft8_spec", 33, 40, 37, id="k2-one-end"),
    pytest.param(3, 2, (0o7, 0o5), "soft8_spec", 1, 100, 99, id="k3-B1"),
    pytest.param(4, 1, (0o15,), "soft8_spec", 130, 64, 31, id="k4r1-t_real<32"),
    pytest.param(5, 2, (0o23, 0o35), "soft8_spec", 33, 100, 77, id="k5"),
    pytest.param(6, 3, (0o53, 0o75, 0o47), "soft8_spec", 130, 100, 100, id="k6r3"),
    pytest.param(7, 2, J.VITERBI27.polys, "soft8_spec", 1, 300, 299, id="k7-B1"),
    pytest.param(7, 4, J.VITERBI47.polys, "soft8_spec", 33, 300, 257, id="k7r4"),
    pytest.param(7, 6, (0o155, 0o117, 0o127, 0o171, 0o133, 0o165), "soft8_spec", 130, 100, 95,
                 id="k7r6"),
    pytest.param(7, 2, (0o155, 0o056), "soft8_spec", 130, 150, 149, id="k7-one-end"),
    pytest.param(8, 5, (0o247, 0o371, 0o225, 0o353, 0o311), "soft8_spec", 33, 100, 63, id="k8r5"),
    pytest.param(9, 2, J.VITERBI29.polys, "soft16_spec", 130, 300, 300, id="k9-soft16"),
    pytest.param(9, 4, J.VITERBI49.polys, "soft8_spec", 1, 200, 199, id="k9r4-B1"),
    pytest.param(9, 3, (0o557, 0o256, 0o711), "soft8_spec", 33, 150, 150, id="k9-one-end"),
    pytest.param(10, 2, (0o1167, 0o1546), "soft8_spec", 33, 100, 99, id="k10-block"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,polys,spec,B,T,t_real", TB_FORM_CASES)
def test_cuda_tb_forms(cuda_device, K, R, polys, spec, B, T, t_real):
    from ka9q_viterbi_comparison_tpu_torch.ops.cuda import kernels2 as pk2
    pc, pn, sym, m, _ = _form_inputs(K, R, polys, spec, B, T)
    rm, rd = pk.acs_update_tb_ref(pc, pn, m, sym, t_real)
    before = dict(_build.LAUNCHES)
    km, kd = pk.acs_update_tb(pc, pn, m, sym, t_real)
    assert torch.equal(km, rm) and torch.equal(kd[:t_real], rd[:t_real])
    if K >= 3:
        km2, kd2 = pk2.acs_update_tb2(pc, pn, m, sym, t_real)
        assert torch.equal(km2, km) and torch.equal(kd2[:t_real], kd[:t_real])
    assert _build.LAUNCHES["acs_update_tb"] == before["acs_update_tb"] + 1
    assert _build.LAUNCHES["acs_update_tb2"] == before["acs_update_tb2"] + (K >= 3)


@pytest.mark.cuda
def test_cuda_tb_launch_geometry_is_what_python_says(cuda_device):
    from ka9q_viterbi_comparison_tpu_torch.ops.cuda import kernels2 as pk2
    fns = _build.library()
    for K, R in ((2, 2), (3, 1), (7, 2), (7, 4), (9, 2), (9, 8), (10, 2), (13, 2), (15, 6)):
        pc = code_from_fields(f"k{K}r{R}", K, R, tuple([(1 << K) - 1] * R))
        assert fns["viterbi_acs_tb_smem"](K, R, 1) == pk.acs_smem_bytes(pc)
        if K <= 13:
            assert fns["viterbi_acs_tb_smem"](K, R, 2) == pk2.tb2_smem_bytes(pc)
