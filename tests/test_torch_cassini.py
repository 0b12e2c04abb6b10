"""Cassini (K=15, r=1/6) through the port's decoder against the JAX
package's, on the CPU: backend ``cuda`` with ``device="cpu"`` (the kernels'
plain versions) vs JAX ``pallas`` (interpret mode), which routes B < 128 to
``large_k2``.  Also the large-K routing table (depth 4 for R <= 2, the pair
kernel else), a JAX half-stream resumed in the port, and the one deliberate
route divergence (K=15 at B > 256)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import dispatch as jdispatch, large_k4 as jlk4
from ka9q_viterbi_comparison_tpu_torch.convert import (
    code_from_fields,
    decoder_state_from_numpy,
    numeric_from_fields,
)
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, large_k2, large_k4

JC = J.VITERBI615


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


def run_both(jc, jn, sym, blocks):
    """Feed the same blocks of steps to a JAX ``pallas`` decoder and a port
    ``cuda`` decoder on the CPU; return both."""
    B = sym.shape[0]
    pc, pn = ported(jc, jn)
    jdec = J.ViterbiDecoder(jc, jn, batch=B, backend="pallas")
    pdec = P.ViterbiDecoder(pc, pn, batch=B, backend="cuda", device="cpu")
    for lo, hi in blocks:
        jdec.update(jnp.asarray(sym[:, lo:hi]))
        pdec.update(torch.from_numpy(sym[:, lo:hi]))
    return jdec, pdec


def assert_same_state(jdec, pdec, n_bits):
    jw = np.concatenate([np.asarray(w) for w in jdec._decision_blocks], axis=1)
    pw = torch.cat(pdec._decision_blocks, dim=1).numpy().view(np.uint32)
    np.testing.assert_array_equal(pw, jw)
    np.testing.assert_array_equal(pdec.metrics.numpy(), np.asarray(jdec.metrics))
    np.testing.assert_array_equal(pdec.renorm_offset.numpy(), np.asarray(jdec.renorm_offset))
    for end in (0, 77):
        np.testing.assert_array_equal(pdec.path_metric(end).numpy(),
                                      np.asarray(jdec.path_metric(end)))
    np.testing.assert_array_equal(pdec.chainback(n_bits).numpy(),
                                  np.asarray(jdec.chainback(n_bits)))


@pytest.mark.parametrize("blocks", [None, (17, 29)], ids=["whole", "odd_blocks"])
def test_cassini_decoder_matches_jax(blocks):
    """B=2 noisy 4-byte frames on the large-K route.  In odd blocks the
    second block's entry shift is non-zero and both blocks end in the
    single-step tail."""
    jn = J.soft8_spec(6)
    data, sym = frames(JC, jn, 2, 4, 3, seed=15)
    T = sym.shape[1]
    cuts = [(0, T)] if blocks is None else [(0, blocks[0]), (blocks[0], T)]
    assert not dispatch.use_inplace(ported(JC, jn)[0], 2)
    jdec, pdec = run_both(JC, jn, sym, cuts)
    if blocks is not None:
        assert (pdec.renorm_offset > 0).all()
    assert_same_state(jdec, pdec, 32)


def test_cassini_forced_inplace(monkeypatch):
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    monkeypatch.setenv("KA9Q_TPU_INPLACE", "1")
    jn = J.soft16_spec(6)
    _, sym = frames(JC, jn, 2, 3, 120, seed=16)
    assert dispatch.use_inplace(ported(JC, jn)[0], 2)
    jdec, pdec = run_both(JC, jn, sym, [(0, 19), (19, sym.shape[1])])
    assert_same_state(jdec, pdec, 24)


def test_resume_jax_cassini_stream_in_port():
    """A JAX decoder's half-stream state -- two blocks in, with a non-zero
    renormalisation offset -- carried across as numpy resumes in the port
    and ends exactly where the JAX decoder ends."""
    jn = J.soft8_spec(6)
    pc, pn = ported(JC, jn)
    _, sym = frames(JC, jn, 2, 4, 3, seed=17)
    jdec = J.ViterbiDecoder(JC, jn, batch=2, backend="pallas")
    for lo, hi in ((0, 12), (12, 25)):
        jdec.update(jnp.asarray(sym[:, lo:hi]))
    assert (np.asarray(jdec.renorm_offset) > 0).all()
    pdec = P.ViterbiDecoder(pc, pn, batch=2, backend="cuda", device="cpu")
    words = np.concatenate([np.asarray(w) for w in jdec._decision_blocks], axis=1)
    decoder_state_from_numpy(pdec, np.asarray(jdec.metrics), words,
                             np.asarray(jdec.renorm_offset), jdec._steps)
    jdec.update(jnp.asarray(sym[:, 25:]))
    pdec.update(torch.from_numpy(sym[:, 25:]))
    assert_same_state(jdec, pdec, 32)


K12 = J.CodeSpec("k12r2", 12, 2, (0o6731, 0o5247))


def test_large_k_routing_table(monkeypatch):
    """K=12 R=2 takes the depth-4 kernel ``acs_update_large4`` in both
    packages at their defaults (the JAX package with no
    ``KA9Q_TPU_LK_DEPTH``; the port has no such setting): words, metrics,
    offset, path metric and bytes are bit-equal.  Cassini (R=6 > 2) is on
    the pair kernel in both."""
    monkeypatch.delenv("KA9Q_TPU_LK_DEPTH", raising=False)
    jn = J.soft8_spec(2)
    _, sym = frames(K12, jn, 2, 4, 3, seed=18)
    T = sym.shape[1]
    assert T % 4 == 3  # ten quads, then a pair and a step on the depth-2 and depth-1 kernels
    calls = []
    for mod in (large_k4, jlk4):
        real = mod.acs_update_large4
        monkeypatch.setattr(mod, "acs_update_large4",
                            lambda *a, mod=mod, real=real, **k: calls.append(mod) or real(*a, **k))
    jdec, pdec = run_both(K12, jn, sym, [(0, T)])
    assert calls == [jlk4, large_k4]
    assert_same_state(jdec, pdec, 32)
    pc, pn = ported(JC, J.soft8_spec(6))
    calls.clear()
    real2 = large_k2.acs_update_large2
    monkeypatch.setattr(large_k2, "acs_update_large2",
                        lambda *a, **k: calls.append(large_k2) or real2(*a, **k))
    assert dispatch._large_update(pc, pn, torch.zeros((1, JC.num_states), dtype=torch.int32),
                                  torch.zeros((1, 2, 6), dtype=torch.int32))[1].shape == (1, 2, 512)
    assert calls == [large_k2]


def test_k15_above_256_keeps_inplace_route():
    """K=15 at B=257: the JAX package leaves the in-place kernel (its TPU
    compiler cap, ``ops/pallas/dispatch.py:89``) for the large-K route, the
    port keeps it.  Bytes and path metric agree; how the path metric splits
    between ``metrics`` and ``renorm_offset`` does not, because only the
    large-K route shifts at block entry."""
    jn = J.soft8_spec(6)
    pc, _ = ported(JC, jn)
    B = 257
    _, sym = frames(JC, jn, B, 1, 3, seed=19)
    assert dispatch.use_inplace(pc, B) and not jdispatch.use_inplace(JC, B)
    assert dispatch.use_inplace(pc, 256) and jdispatch.use_inplace(JC, 256)
    jdec, pdec = run_both(JC, jn, sym, [(0, 11), (11, sym.shape[1])])
    np.testing.assert_array_equal(pdec.chainback(8).numpy(), np.asarray(jdec.chainback(8)))
    for end in (0, 5):
        np.testing.assert_array_equal(pdec.path_metric(end).numpy(),
                                      np.asarray(jdec.path_metric(end)))
    j_off, p_off = np.asarray(jdec.renorm_offset), pdec.renorm_offset.numpy()
    assert (p_off == 0).all() and (j_off > 0).all()
    np.testing.assert_array_equal(pdec.metrics.numpy(), np.asarray(jdec.metrics) + j_off[:, None])
