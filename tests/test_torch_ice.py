"""The K=24 (ICE) slice of the port as a whole, at CPU sizes: the large-K
half of ``dispatch.phase_fns`` against the JAX package's (Pallas in interpret
mode) on each of its routes -- canonical words up to K=15, the f8 table for
whole frames above, the f4 table for part of a frame, words and built tables
otherwise -- in decoded bytes, metrics, offset and words or table; and the
depth-4 route through ``ViterbiDecoder``.  Tolerance: exact equality."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import dispatch as jdispatch
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, large_k2, large_k4
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors

K12 = J.CodeSpec("k12r2", K=12, R=2, polys=(0o6731, 0o5247))
K17 = J.CodeSpec("k17test", K=17, R=2, polys=(0o345567, 0o251331))


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def frames(jc, jn, B, n_bytes, noise, seed):
    """``(data [B, N] uint8, symbols [B, T, R] int32)``: encoded + uniform
    integer noise, clipped to the rails."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    sym = np.clip(sym + rng.integers(-noise, noise + 1, size=sym.shape), jn.soft_low, jn.soft_high)
    return data, sym.astype(np.int32)


def run_phases(jc, jn, sym, num_data_bits):
    """The four phases in both packages on the same symbols:
    ``((metrics, words, offset, bytes) of JAX, ... of the port)``."""
    B = sym.shape[0]
    pc, pn = ported(jc, jn)
    j_init, j_update, j_chainback, j_prepare = jdispatch.phase_fns(jc, jn, num_data_bits, B)[:4]
    jm, jw, joff = j_update(j_init(B), j_prepare(jnp.asarray(sym)))
    fns = dispatch.phase_fns(pc, pn, num_data_bits, B, device="cpu")
    assert len(fns) == 6 and all(callable(f) for f in fns)
    p_init, p_update, p_chainback, p_prepare = fns[:4]
    pm, pw, poff = p_update(p_init(B), p_prepare(sym))
    return (jm, jw, joff, j_chainback(jw)), (pm, pw, poff, p_chainback(pw))


def assert_words(pw, jw):
    np.testing.assert_array_equal(pw.numpy().view(np.uint32), np.asarray(jw))


def test_phase_fns_k12_words_route():
    """K <= 15: the update is ``_large_update`` (depth 4 at R=2), the
    traceback the port's ``chainback``; noisy frames."""
    jn = J.soft8_spec(2)
    data, sym = frames(K12, jn, 2, 8, 3, seed=12)
    (jm, jw, joff, jout), (pm, pw, poff, pout) = run_phases(K12, jn, sym, 64)
    assert isinstance(pw, torch.Tensor) and pw.shape == (2, sym.shape[1], 64)
    assert_words(pw, jw)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))


def test_phase_fns_k17_f8_route():
    """K > 15, a whole frame: both packages return ``{"f8": table}`` and no
    words, the same table, and decode the same bytes (noiseless: the data)."""
    jn = J.soft8_spec(2)
    data, sym = frames(K17, jn, 2, 4, 0, seed=21)
    (jm, jw, joff, jout), (pm, pw, poff, pout) = run_phases(K17, jn, sym, 32)
    assert isinstance(jw, dict) and isinstance(pw, dict) and set(pw) == set(jw) == {"f8"}
    assert pw["f8"].shape == jw["f8"].shape == (4, 8, 2, K17.num_states // 32)
    assert_words(pw["f8"], jw["f8"])
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
    assert count_bit_errors(pout, data) == 0


def test_phase_fns_k17_f4_route():
    """Fewer data bits asked than the frame holds: the two anchor
    derivations of the f8 route would not agree, so both packages take the
    f4 table (noisy frames)."""
    jn = J.soft8_spec(2)
    data, sym = frames(K17, jn, 2, 4, 3, seed=22)
    (jm, jw, joff, jout), (pm, pw, poff, pout) = run_phases(K17, jn, sym, 24)
    assert set(pw) == set(jw) == {"f4"}
    assert pw["f4"].shape == jw["f4"].shape == (8, 4, 2, K17.num_states // 32)
    assert_words(pw["f4"], jw["f4"])
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))
    assert pout.shape == (2, 3)


def test_phase_fns_k17_words_and_tables_route():
    """A block whose span past the anchor is no multiple of 4 (two symbols
    cut off the frame): time-major words and the tables built from them."""
    jn = J.soft8_spec(2)
    data, sym = frames(K17, jn, 2, 4, 3, seed=23)
    sym = np.ascontiguousarray(sym[:, :-2])
    (jm, jw, joff, jout), (pm, pw, poff, pout) = run_phases(K17, jn, sym, 24)
    assert isinstance(pw, tuple) and isinstance(jw, tuple)
    assert_words(pw[0], jw[0])
    assert set(pw[1]) == set(jw[1]) == {"f4", "g2"}
    for name in pw[1]:
        assert_words(pw[1][name], jw[1][name])
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(pout.numpy(), np.asarray(jout))


def test_phase_fns_pair_kernel_family():
    """Cassini (R=6): the pair kernel's words and ``chainback``, noiseless."""
    jc, jn = J.VITERBI615, J.soft8_spec(6)
    pc, pn = ported(jc, jn)
    data, sym = frames(jc, jn, 2, 2, 0, seed=24)
    init_fn, update_fn, chainback_fn, prepare_fn = dispatch.phase_fns(pc, pn, 16, 2, "cpu")[:4]
    m, w, off = update_fn(init_fn(2), prepare_fn(torch.from_numpy(sym)))
    want = large_k2.acs_update_large2(pc, pn, init_fn(2), torch.from_numpy(sym))
    assert all(torch.equal(a, b) for a, b in zip((m, w, off), want))
    assert count_bit_errors(chainback_fn(w), data) == 0


def test_phase_fns_other_families_wait():
    """K <= 9, and the in-place family at its batch, no longer wait: every
    family is served with six callables (``test_torch_phase_fns.py`` holds
    them to the JAX package), in the kernels' own ``[S, B]`` layout."""
    for code, batch in ((P.VITERBI27, 8), (P.VITERBI615, 256), (P.VITERBI615, None)):
        fns = dispatch.phase_fns(code, P.soft8_spec(code.R), 64, batch, "cpu")
        assert len(fns) == 6 and all(callable(f) for f in fns)
        assert fns[0](2).shape == (code.num_states, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dispatch.phase_fns(P.VITERBI224, P.soft8_spec(2), 64, 8)


def test_routes_follow_the_code_alone():
    """Depth 4 for R <= 2 from 512 states (K=10) on, the pair kernel else;
    ICE's routed frame takes f8 with lead 7 and anchor 23."""
    k10 = P.CodeSpec("k10", 10, 2, (0o1234, 0o1571))
    assert large_k4.supports(k10) and large_k4.supports(P.VITERBI224)
    assert not large_k4.supports(P.VITERBI29) and not large_k4.supports(P.VITERBI615)
    calls = []
    real4, real2 = large_k4.acs_update_large4_fields8, large_k4.acs_update_large4_fields

    def spy(real):
        def run(code, numeric, metrics, symbols, lead, *a):
            calls.append((real.__name__, symbols.shape[1], lead))
            raise StopIteration
        return run

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(large_k4, "acs_update_large4_fields8", spy(real4))
        mp.setattr(large_k4, "acs_update_large4_fields", spy(real2))
        ice = P.VITERBI224
        for nbits in (64, 56):
            update_fn = dispatch.phase_fns(ice, P.soft8_spec(2), nbits, 8, "cpu")[1]
            with pytest.raises(StopIteration):
                update_fn(None, torch.zeros((1, 87, 2), dtype=torch.int32))
    finally:
        mp.undo()
    assert calls == [("acs_update_large4_fields8", 87, 7), ("acs_update_large4_fields", 87, 3)]


def test_decoder_takes_depth4_at_k12():
    """K=12 r=1/2 through ``ViterbiDecoder`` in two blocks (19 and the rest):
    the depth-4 route in both packages, every output equal."""
    jn = J.soft8_spec(2)
    pc, pn = ported(K12, jn)
    data, sym = frames(K12, jn, 2, 4, 3, seed=25)
    jdec = J.ViterbiDecoder(K12, jn, batch=2, backend="pallas")
    pdec = P.ViterbiDecoder(pc, pn, batch=2, backend="cuda", device="cpu")
    for lo, hi in ((0, 19), (19, sym.shape[1])):
        jdec.update(jnp.asarray(sym[:, lo:hi]))
        pdec.update(torch.from_numpy(sym[:, lo:hi]))
    for jw, pw in zip(jdec._decision_blocks, pdec._decision_blocks):
        assert_words(pw, jw)
    np.testing.assert_array_equal(pdec.metrics.numpy(), np.asarray(jdec.metrics))
    np.testing.assert_array_equal(pdec.renorm_offset.numpy(), np.asarray(jdec.renorm_offset))
    assert (pdec.renorm_offset > 0).all()
    np.testing.assert_array_equal(pdec.chainback(32).numpy(), np.asarray(jdec.chainback(32)))
