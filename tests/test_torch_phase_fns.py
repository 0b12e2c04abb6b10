"""``dispatch.phase_fns`` of the port, every family, against the JAX
package's (Pallas in interpret mode) on the same numpy inputs: ``init_fn``,
``prepare_fn``, ``update_fn`` (metrics, words up to T, offset),
``chainback_fn`` bytes, and the chains ``make_update_chain(k)`` /
``make_chainback_chain(k)`` for k in {1, 3}.  The K <= 9 family (VITERBI29
soft16), the in-place family (forced: K=7 and a small K=15 case) and the
large-K family (K=12 R=2).  A chain holds no host synchronisation between its
links: its source calls neither ``.item()`` nor ``int(tensor)``.  Tolerance:
exact equality."""

import dataclasses
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import dispatch as jdispatch
from ka9q_viterbi_comparison_tpu_torch import convert
from ka9q_viterbi_comparison_tpu_torch.harness import bench
from ka9q_viterbi_comparison_tpu_torch.ops import radix_planes
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, inplace, kernels
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors

K12 = J.CodeSpec("k12r2", K=12, R=2, polys=(0o6731, 0o5247))

# family -> (code, numeric spec, batch, frame bytes, noise, in-place env value)
FAMILIES = {
    "k9-state-order": (J.VITERBI29, "soft16_spec", 2, 16, 160, None),
    "k7-inplace": (J.VITERBI27, "soft8_spec", 3, 8, 3, "1"),
    "k15-inplace": (J.VITERBI615, "soft8_spec", 3, 4, 3, "1"),
    "k12-large": (K12, "soft8_spec", 2, 8, 3, None),
}
NATIVE = ("k9-state-order", "k7-inplace", "k15-inplace")


def ported(jc, jn):
    return (convert.code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            convert.numeric_from_fields(**dataclasses.asdict(jn)))


class Family:
    """Both packages' phases of one family on the same noisy frames, run
    once per test module (the JAX side compiles each phase once)."""

    def __init__(self, name):
        jc, spec, B, n_bytes, noise, env = FAMILIES[name]
        self.name, self.jc, self.B, self.nbits, self.env = name, jc, B, n_bytes * 8, env
        self.native = name in NATIVE
        jn = getattr(J, spec)(jc.R)
        rng = np.random.default_rng(sum(map(ord, name)))
        self.data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
        sym = np.asarray(encode_frames(jc, jn, jnp.asarray(self.data))).reshape(B, -1, jc.R)
        self.sym = np.clip(sym + rng.integers(-noise, noise + 1, size=sym.shape),
                           jn.soft_low, jn.soft_high).astype(np.int32)
        self.T = self.sym.shape[1]
        mp = pytest.MonkeyPatch()
        try:
            if env is not None:
                mp.setenv("KA9Q_TPU_INPLACE", env)
                mp.setenv("KA9Q_TORCH_INPLACE", env)
            self.jf = jdispatch.phase_fns(jc, jn, self.nbits, B)
            self.pf = dispatch.phase_fns(*ported(jc, jn), self.nbits, B, device="cpu")
            self.j_m0, self.p_m0 = self.jf[0](B), self.pf[0](B)
            self.j_prep, self.p_prep = self.jf[3](jnp.asarray(self.sym)), self.pf[3](self.sym)
            self.j_upd = self.jf[1](self.j_m0, self.j_prep)
            self.p_upd = self.pf[1](self.p_m0, self.p_prep)
            self.j_out, self.p_out = self.jf[2](self.j_upd[1]), self.pf[2](self.p_upd[1])
        finally:
            mp.undo()

    def assert_words(self, pw, jw):
        """Words of either format: native ``(dec, T, B)`` up to T, or the
        large-K family's batch-major tensor."""
        if self.native:
            assert pw[1:] == (self.T, self.B) and tuple(jw[1:]) == (self.T, self.B)
            np.testing.assert_array_equal(pw[0].numpy().view(np.uint32)[:self.T],
                                          np.asarray(jw[0])[:self.T])
        else:
            np.testing.assert_array_equal(pw.numpy().view(np.uint32), np.asarray(jw))


_cache: dict[str, Family] = {}


def _family(name):
    if name not in _cache:
        _cache[name] = Family(name)
    return _cache[name]


@pytest.fixture(params=list(FAMILIES))
def fam(request):
    return _family(request.param)


@pytest.fixture(params=list(NATIVE))
def native_fam(request):
    return _family(request.param)


def test_six_callables_and_no_not_implemented(fam):
    assert len(fam.pf) == 6 and all(callable(f) for f in fam.pf)


def test_init_fn(fam):
    want = (fam.jc.num_states, fam.B) if fam.native else (fam.B, fam.jc.num_states)
    assert tuple(fam.p_m0.shape) == want and fam.p_m0.dtype == torch.int32
    np.testing.assert_array_equal(fam.p_m0.numpy(), np.asarray(fam.j_m0))


def test_prepare_fn(fam):
    if not fam.native:
        np.testing.assert_array_equal(fam.p_prep.numpy(), np.asarray(fam.j_prep))
        return
    (p_sym, pT, pB), (j_sym, jT, jB) = fam.p_prep, fam.j_prep
    assert (pT, pB) == (jT, jB) == (fam.T, fam.B)
    # time padded to whole traceback words, which is what the walk needs
    assert p_sym.shape == (-(-fam.T // 32) * 32, fam.jc.R, fam.B) and p_sym.is_contiguous()
    np.testing.assert_array_equal(p_sym.numpy()[:fam.T], np.asarray(j_sym)[:fam.T])
    assert not p_sym[fam.T:].any()


def test_update_fn(fam):
    (jm, jw, joff), (pm, pw, poff) = fam.j_upd, fam.p_upd
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    fam.assert_words(pw, jw)
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))


def test_chainback_fn(fam):
    assert fam.p_out.shape == (fam.B, fam.nbits // 8) and fam.p_out.dtype == torch.uint8
    np.testing.assert_array_equal(fam.p_out.numpy(), np.asarray(fam.j_out))


def test_chainback_fn_walks_the_jax_words(native_fam):
    """The JAX package's native phase state, carried across as numpy by
    ``convert``, decodes in the port to the JAX bytes (the large-K family's
    batch-major words cross in ``test_torch_ice.py``)."""
    fam = native_fam
    words = convert.native_words_from_numpy(
        (np.asarray(fam.j_upd[1][0]), fam.T, fam.B))
    assert torch.equal(convert.metrics_from_numpy(np.asarray(fam.j_upd[0])), fam.p_upd[0])
    np.testing.assert_array_equal(fam.pf[2](words).numpy(), np.asarray(fam.j_out))


@pytest.mark.parametrize("k", [1, 3])
def test_make_update_chain(fam, k):
    mp = pytest.MonkeyPatch()
    try:
        if fam.env is not None:
            mp.setenv("KA9Q_TPU_INPLACE", fam.env)
            mp.setenv("KA9Q_TORCH_INPLACE", fam.env)
        jm, jw = fam.jf[5](k)(fam.j_m0, fam.j_prep)
        pm, pw = fam.pf[5](k)(fam.p_m0, fam.p_prep)
    finally:
        mp.undo()
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    fam.assert_words(pw, jw)
    if k == 1:  # one link is the update phase itself
        assert torch.equal(pm, fam.p_upd[0])


@pytest.mark.parametrize("k", [1, 3])
def test_make_chainback_chain(fam, k):
    mp = pytest.MonkeyPatch()
    try:
        if fam.env is not None:
            mp.setenv("KA9Q_TPU_INPLACE", fam.env)
            mp.setenv("KA9Q_TORCH_INPLACE", fam.env)
        jout = fam.jf[4](k)(fam.j_upd[1])
        pout = fam.pf[4](k)(fam.p_upd[1])
    finally:
        mp.undo()
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
    if k == 1:
        assert torch.equal(pout, fam.p_out)


def test_noiseless_round_trip_every_family():
    """Noiseless frames decode with 0 bit errors through the port's phases."""
    for name, (jc, spec, B, n_bytes, _, env) in FAMILIES.items():
        mp = pytest.MonkeyPatch()
        try:
            if env is not None:
                mp.setenv("KA9Q_TORCH_INPLACE", env)
            jn = getattr(J, spec)(jc.R)
            pc, pn = ported(jc, jn)
            data = np.random.default_rng(5).integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
            sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
            init_fn, update_fn, chainback_fn, prepare_fn = dispatch.phase_fns(
                pc, pn, n_bytes * 8, B, "cpu")[:4]
            _, words, _ = update_fn(init_fn(B), prepare_fn(sym.astype(np.int32)))
            assert count_bit_errors(chainback_fn(words), data) == 0, name
        finally:
            mp.undo()


def test_family_follows_code_and_batch(monkeypatch):
    """K <= 9 below the in-place batch and at B >= 1024 with the in-place
    route off: state-order words; 5 < K <= 15 from B=128: position-packed."""
    calls = []
    for mod, name in ((kernels, "chainback_tb"), (inplace, "chainback_inplace")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name: calls.append(_n) or (_ for _ in ()).throw(
            StopIteration))
    dec = (torch.zeros((32, 2, 2), dtype=torch.int32), 20, 2)
    for code, batch, want in ((P.VITERBI27, 8, "chainback_tb"),
                              (P.VITERBI27, 512, "chainback_inplace"),
                              (P.VITERBI27, None, "chainback_inplace")):
        with pytest.raises(StopIteration):
            dispatch.phase_fns(code, P.soft8_spec(2), 8, batch, "cpu")[2](dec)
        assert calls[-1] == want
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "0")
    with pytest.raises(StopIteration):
        dispatch.phase_fns(P.VITERBI27, P.soft8_spec(2), 8, 1024, "cpu")[2](dec)
    assert calls[-1] == "chainback_tb"


def test_end_state_may_be_a_tensor():
    """An int, a 0-d tensor and a ``[1, B]`` tensor of the same value walk
    alike, through ``chainback`` and through the plane walk."""
    code, B = P.VITERBI27, 3
    rng = np.random.default_rng(9)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(B, 30, 2)).astype(np.int32))
    want = dispatch.chainback(code, words, 16, 37)
    for end in (torch.tensor(37), torch.tensor(37, dtype=torch.uint8),
                torch.full((1, B), 37, dtype=torch.int32), torch.tensor(37 + 64)):
        assert torch.equal(dispatch.chainback(code, words, 16, end), want)
    per_frame = torch.tensor([37, 5, 63])
    got = dispatch.chainback(code, words, 16, per_frame)
    for b in range(B):
        assert torch.equal(got[b], dispatch.chainback(code, words, 16, int(per_frame[b]))[b])
    k17 = P.CodeSpec("k17test", 17, 2, (0o345567, 0o251331))
    w17 = torch.from_numpy(rng.integers(-2**31, 2**31, size=(40, 2, k17.num_states // 32))
                           .astype(np.int32))
    tabs = radix_planes.build_plane_tables(k17, w17, 16, max_width=8)
    assert torch.equal(radix_planes.chainback_planes(k17, w17, tabs, 24, torch.tensor(77), 16),
                       radix_planes.chainback_planes(k17, w17, tabs, 24, 77, 16))


CHAIN_SOURCES = [dispatch.make_chains, dispatch._native_phase_fns, dispatch.phase_fns,
                 dispatch._end_states, bench._phases_for_backend]


@pytest.mark.parametrize("fn", CHAIN_SOURCES, ids=lambda f: f.__name__)
def test_chains_hold_no_host_synchronisation(fn):
    """The end state travels between the links as a device tensor: the
    bodies that build the chains read no tensor back to the host."""
    src = inspect.getsource(fn)
    assert "make_chains" in src or fn is dispatch._end_states
    body = re.sub(r'""".*?"""', "", src, flags=re.S)
    for banned in (".item(", ".cpu(", ".numpy(", ".tolist(", "int(out", "int(es", "synchronize"):
        assert banned not in body, f"{fn.__name__} calls {banned}"
    if fn is dispatch._end_states:
        # the one int() there converts a Python int, on the branch tensors never take
        assert body.count("int(") == 1 and "int(endstate) & mask" in body
    else:
        assert "int(" not in body.replace("torch.int32", "").replace("print(", "")
