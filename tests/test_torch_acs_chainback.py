"""The port's portable ACS update and traceback against the JAX package's
``ops.acs`` / ``ops.chainback`` (exact equality)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs, chainback as jcb
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops import acs as pacs, chainback as pcb

CODES = [pytest.param(J.VITERBI27, 12, id="viterbi27"),
         pytest.param(J.VITERBI47, 8, id="viterbi47"),
         pytest.param(J.VITERBI29, 8, id="viterbi29"),
         pytest.param(J.VITERBI615, 2, id="viterbi615")]


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def noisy(jc, jn, B, n_bytes, seed):
    """Encoded random frames + uniform integer noise, clipped: [B, T, R] int32."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    span = jn.soft_high - jn.soft_low
    sym = sym + rng.integers(-(span * 2) // 3, (span * 2) // 3 + 1, size=sym.shape)
    return data, np.clip(sym, jn.soft_low, jn.soft_high).astype(np.int32)


def assert_same_update(j_out, p_out):
    jm, jw, jo = (np.asarray(x) for x in j_out)
    pm, pw, po = p_out
    np.testing.assert_array_equal(pm.numpy(), jm)
    np.testing.assert_array_equal(pw.numpy().view(np.uint32), jw)
    np.testing.assert_array_equal(po.numpy(), jo)


@pytest.mark.parametrize("renorm", [0, 16])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("jc,n_bytes", CODES)
def test_acs_update_matches(jc, n_bytes, fused, renorm):
    jn = dataclasses.replace(J.soft8_spec(jc.R), renorm_interval=renorm)
    pc, pn = ported(jc, jn)
    B = 3
    _, sym = noisy(jc, jn, B, n_bytes, seed=jc.K + renorm)
    j_out = jacs.acs_update(jc, jn, jacs.init_metrics(jc, jn, B, 5), jnp.asarray(sym), fused)
    p_out = pacs.acs_update(pc, pn, pacs.init_metrics(pc, pn, B, 5), torch.from_numpy(sym), fused)
    assert_same_update(j_out, p_out)


@pytest.mark.parametrize("spec", ["soft16_spec", "hard8_spec", "ka9q_offset_binary_spec"])
def test_acs_update_other_specs(spec):
    jc = J.VITERBI27
    jn = getattr(J, spec)(2) if spec != "ka9q_offset_binary_spec" else J.ka9q_offset_binary_spec()
    pc, pn = ported(jc, jn)
    _, sym = noisy(jc, jn, 2, 10, seed=7)
    j_out = jacs.acs_update(jc, jn, jacs.init_metrics(jc, jn, 2), jnp.asarray(sym), True)
    p_out = pacs.acs_update(pc, pn, pacs.init_metrics(pc, pn, 2), torch.from_numpy(sym), True)
    assert_same_update(j_out, p_out)


def test_acs_update_blockwise():
    """Three uneven blocks through the port equal one JAX call (renorm off,
    so the offset schedule does not depend on block edges)."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    _, sym = noisy(jc, jn, 4, 16, seed=11)
    jm, jw, _ = jacs.acs_update(jc, jn, jacs.init_metrics(jc, jn, 4), jnp.asarray(sym), False)
    m = pacs.init_metrics(pc, pn, 4)
    words = []
    for lo, hi in ((0, 50), (50, 87), (87, sym.shape[1])):
        m, w, off = pacs.acs_update(pc, pn, m, torch.from_numpy(sym[:, lo:hi]), True)
        words.append(w)
        assert not off.any()
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(torch.cat(words, 1).numpy().view(np.uint32), np.asarray(jw))


def test_init_metrics_matches():
    jc, jn = J.VITERBI29, J.soft16_spec(2)
    pc, pn = ported(jc, jn)
    for start in (0, 7, 300):
        np.testing.assert_array_equal(pacs.init_metrics(pc, pn, 3, start).numpy(),
                                      np.asarray(jacs.init_metrics(jc, jn, 3, start)))


@pytest.mark.parametrize("rotated", [False, True])
@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI29], ids=["viterbi27", "viterbi29"])
def test_chainback_bits_random_words(jc, rotated):
    """Arbitrary uint32 words and end states: every bit the walk can read."""
    pc = code_from_fields(jc.name, jc.K, jc.R, jc.polys)
    rng = np.random.default_rng(jc.K + rotated)
    B, T = 5, 70
    words = rng.integers(0, 2 ** 32, size=(B, T, jc.decision_words), dtype=np.uint32)
    end = rng.integers(0, jc.num_states, size=(B,)).astype(np.int32)
    n = T - (jc.K - 1)
    jb, js = jcb.chainback_bits(jc, jnp.asarray(words), n, jnp.asarray(end), rotated)
    pb, ps = pcb.chainback_bits(pc, torch.from_numpy(words.view(np.int32)), n,
                                torch.from_numpy(end), rotated)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("rotated", [False, True])
def test_chainback_decodes_like_jax(rotated):
    """Words from the JAX update (state order, or position order from
    ``acs_update_rotating``) decode to the same bytes through both walks."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc = code_from_fields(jc.name, jc.K, jc.R, jc.polys)
    _, sym = noisy(jc, jn, 3, 12, seed=13)
    m0 = jacs.init_metrics(jc, jn, 3)
    if rotated:
        _, words, _ = jacs.acs_update_rotating(jc, jn, m0, jnp.asarray(sym), 0)
    else:
        _, words, _ = jacs.acs_update(jc, jn, m0, jnp.asarray(sym), False)
    want = np.asarray(jcb.chainback(jc, words, 96, 0, rotated))
    got = pcb.chainback(pc, torch.from_numpy(np.array(words).view(np.int32)), 96, 0, rotated)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        pcb.chainback(pc, torch.from_numpy(np.array(words).view(np.int32)), 95)
