"""The depth-2 state-order ACS of the port (``ops/cuda/kernels2.py``).

On the CPU its plain version (which the wrapper runs for CPU tensors) is held
word for word against the JAX package's ``kernels2.acs_update_tb2`` in
interpret mode -- metrics and ``dec[:t_real]`` -- and against the port's plain
single-step version; the dispatch's batch threshold and its route at B=1024
are held against the JAX dispatch.  Tests marked ``cuda`` hold the CUDA kernel
against its plain version and against the ``acs_update_tb`` kernel, and skip
where there is no card.  Tolerance: exact equality (integer arithmetic)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import acs as jacs
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import dispatch as jdispatch, kernels as jk, \
    kernels2 as jk2
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, dispatch, kernels as pk, \
    kernels2 as pk2

K5 = J.CodeSpec("k5r2", K=5, R=2, polys=(0o23, 0o35))


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def inputs(jc, jn, B, n_bytes, noise, seed):
    """Noisy symbols ``[T, R, B]`` and metrics ``[S, B]`` (the reset metrics
    plus a random spread), made with numpy from ``seed``."""
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


# (code, numeric spec, noise, batch, frame bytes, steps cut off the frame)
PALLAS_CASES = [
    pytest.param(J.VITERBI27, "soft8_spec", 4, 4, 8, 0, id="viterbi27-even"),
    pytest.param(J.VITERBI27, "soft8_spec", 4, 4, 8, 1, id="viterbi27-odd"),
    pytest.param(J.VITERBI27, "soft8_spec", 4, 2, 40, 1, id="viterbi27-past-a-time-block"),
    pytest.param(J.VITERBI49, "soft16_spec", 160, 2, 4, 0, id="viterbi49-soft16"),
    pytest.param(K5, "soft8_spec", 3, 3, 4, 1, id="k5-odd"),
]


@pytest.mark.parametrize("jc,spec,noise,B,n_bytes,cut", PALLAS_CASES)
def test_acs_update_tb2_ref_matches_pallas(jc, spec, noise, B, n_bytes, cut):
    jn = getattr(J, spec)(jc.R)
    pc, pn = ported(jc, jn)
    s, m0 = inputs(jc, jn, B, n_bytes, noise, seed=100 + jc.K + cut)
    T = s.shape[0] - cut
    TB = jk.pick_time_block(jc, B)
    s = pad_time(s, -(-s.shape[0] // TB) * TB)
    jm, jd = jk2.acs_update_tb2(jc, jn, jnp.asarray(m0), jnp.asarray(s), T, True)
    pm, pd = pk2.acs_update_tb2(pc, pn, torch.from_numpy(m0), torch.from_numpy(s), T)
    assert pd.shape == (s.shape[0], jc.decision_words, B) and pd.dtype == torch.int32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(words_u32(pd)[:T], np.asarray(jd)[:T])
    assert not pd[T:].any()  # steps past t_real never run


def test_past_a_time_block_case_is_past_one():
    """The third case above crosses a JAX time block (256 steps at this
    batch) and ends on an odd step of the next."""
    T = J.VITERBI27.transmit_bits(40) - 1
    assert jk.pick_time_block(J.VITERBI27, 2) == 256 and T > 256 and (T - 256) % 2 == 1


TB_CASES = [(P.CodeSpec(f"k{K}", K, len(polys), polys), cut)
            for K, polys in ((3, (0o7, 0o5)), (4, (0o15, 0o17)), (5, (0o23, 0o35)),
                             (6, (0o53, 0o75, 0o47)), (7, P.VITERBI27.polys),
                             (7, P.VITERBI47.polys), (8, (0o247, 0o371)), (9, P.VITERBI29.polys),
                             (9, P.VITERBI49.polys))
            for cut in (0, 1)]


@pytest.mark.parametrize("code,cut", TB_CASES,
                         ids=[f"K{c.K}-R{c.R}-{'odd' if cut else 'even'}" for c, cut in TB_CASES])
def test_acs_update_tb2_ref_equals_tb_ref(code, cut):
    """Both plain versions compute one function, for every K the depth-2
    form serves on its route (3..9), at an even and an odd ``t_real`` that
    ends inside a 32-step stage."""
    numeric = P.soft8_spec(code.R)
    rng = np.random.default_rng(code.K * 10 + code.R + cut)
    B, Tp = 3, 44
    t_real = 42 - cut
    m0 = torch.from_numpy(rng.integers(0, 40, size=(code.num_states, B)).astype(np.int32))
    s = torch.from_numpy(rng.integers(-3, 4, size=(Tp, code.R, B)).astype(np.int32))
    m1, d1 = pk.acs_update_tb_ref(code, numeric, m0, s, t_real)
    m2, d2 = pk2.acs_update_tb2_ref(code, numeric, m0, s, t_real)
    assert torch.equal(m1, m2) and torch.equal(d1, d2)


def test_wrapper_refuses_what_it_cannot_serve():
    """K=2 has no four predecessors a thread: an error, never a quiet
    give-way to ``acs_update_tb``; and ``t_real`` outside the symbols."""
    k2 = P.CodeSpec("k2", 2, 2, (0o3, 0o1))
    with pytest.raises(ValueError, match="3 <= K <= 13"):
        pk2.acs_update_tb2(k2, P.soft8_spec(2), torch.zeros((2, 1), dtype=torch.int32),
                           torch.zeros((4, 2, 1), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="t_real"):
        pk2.acs_update_tb2(P.VITERBI27, P.soft8_spec(2), torch.zeros((64, 1), dtype=torch.int32),
                           torch.zeros((4, 2, 1), dtype=torch.int32), 5)
    assert pk2.tb2_smem_bytes(P.VITERBI27) == 4 * (2 * 64 + 32 * 2)
    assert "acs_update_tb2" in _build.LAUNCHES and "viterbi_acs_tb2" in _build._SIGNATURES


@pytest.mark.parametrize("batch,name", [(512, "acs_update_tb"), (1023, "acs_update_tb"),
                                        (1024, "acs_update_tb2"), (2048, "acs_update_tb2")])
def test_small_k_impl_threshold(batch, name):
    """The JAX package's threshold, read on the batch itself."""
    assert dispatch._small_k_impl(batch).__name__ == name
    assert jdispatch._small_k_impl(batch).__name__ == name


def test_dispatch_routes_b1024_to_tb2_and_matches_jax(monkeypatch):
    """B=1024 with the in-place route off in both packages: the port's
    ``acs_update`` goes through ``acs_update_tb2`` (once) and gives the JAX
    dispatch's metrics, words and offset; the decoded bytes agree too."""
    monkeypatch.setenv("KA9Q_TPU_INPLACE", "0")
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "0")
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    B, n_bytes = 1024, 2
    rng = np.random.default_rng(1024)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    sym = np.clip(sym + rng.integers(-3, 4, size=sym.shape), -3, 3).astype(np.int32)
    m0 = np.asarray(jacs.init_metrics(jc, jn, B))
    jm, jw, joff = jdispatch.acs_update(jc, jn, jnp.asarray(m0), jnp.asarray(sym))

    calls = []
    real = pk2.acs_update_tb2
    monkeypatch.setattr(pk2, "acs_update_tb2", lambda *a: calls.append(a[2].shape) or real(*a))
    monkeypatch.setattr(pk, "acs_update_tb", lambda *a: pytest.fail("took the single-step kernel"))
    pm, pw, poff = dispatch.acs_update(pc, pn, torch.from_numpy(m0.copy()), torch.from_numpy(sym))
    assert calls == [(64, 1024)]
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(words_u32(pw.contiguous()), np.asarray(jw))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(dispatch.chainback(pc, pw, 16).numpy(),
                                  np.asarray(jdispatch.chainback(jc, jw, 16)))


# -- on the card: the CUDA kernel against its plain version and against tb --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [
    pytest.param(J.VITERBI27, 130, 24, 0, id="viterbi27-even"),
    pytest.param(J.VITERBI27, 130, 24, 1, id="viterbi27-odd"),
    pytest.param(J.VITERBI27, 130, 24, 13, id="viterbi27-mid-stage"),
    pytest.param(J.VITERBI29, 70, 16, 1, id="viterbi29-odd"),
    pytest.param(J.VITERBI47, 70, 16, 0, id="viterbi47"),
    pytest.param(J.VITERBI49, 70, 16, 1, id="viterbi49-odd"),
    pytest.param(K5, 33, 8, 1, id="k5-odd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("jc,B,n_bytes,cut", CARD_CASES)
def test_cuda_acs_update_tb2(cuda_device, jc, B, n_bytes, cut):
    jn = J.soft8_spec(jc.R)
    pc, pn = ported(jc, jn)
    s, m0 = inputs(jc, jn, B, n_bytes, 3, seed=7 + cut)
    s, m0 = torch.from_numpy(s).cuda(), torch.from_numpy(m0).cuda()
    T = s.shape[0] - cut
    before = _build.LAUNCHES["acs_update_tb2"]
    km, kd = pk2.acs_update_tb2(pc, pn, m0, s, T)
    assert _build.LAUNCHES["acs_update_tb2"] == before + 1
    rm, rd = pk2.acs_update_tb2_ref(pc, pn, m0, s, T)
    tm, td = pk.acs_update_tb(pc, pn, m0, s, T)
    assert torch.equal(km, rm) and torch.equal(kd[:T], rd[:T])
    assert torch.equal(km, tm) and torch.equal(kd[:T], td[:T])


@pytest.mark.cuda
def test_cuda_tb2_refuses_k2(cuda_device):
    k2 = P.CodeSpec("k2", 2, 2, (0o3, 0o1))
    with pytest.raises(ValueError, match="3 <= K <= 13"):
        pk2.acs_update_tb2(k2, P.soft8_spec(2), torch.zeros((2, 1), dtype=torch.int32).cuda(),
                           torch.zeros((4, 2, 1), dtype=torch.int32).cuda(), 4)
