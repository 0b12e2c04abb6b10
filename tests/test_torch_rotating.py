"""``acs_update_rotating`` of the port's portable path against the JAX
function on the same numpy inputs: metrics (state order), position-packed
words and renormalisation offset, at K=7 and K=11, ``t0`` in {0, 1, 5}, with
a ``renorm_interval`` that fires several times; and the decoded bytes through
the rotated walk.  Tolerance: exact equality."""

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
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import inplace

K11 = J.CodeSpec("k11r2", K=11, R=2, polys=(0o3345, 0o3613))
CODES = [pytest.param(J.VITERBI27, id="viterbi27"), pytest.param(K11, id="k11r2")]


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def noisy_frames(jc, jn, B, n_bytes, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    sym = np.clip(sym + rng.integers(-3, 4, size=sym.shape), jn.soft_low, jn.soft_high)
    return data, sym.astype(np.int32), rng


@pytest.mark.parametrize("t0", [0, 1, 5])
@pytest.mark.parametrize("jc", CODES)
def test_matches_jax(jc, t0):
    jn = dataclasses.replace(J.soft8_spec(jc.R), renorm_interval=7)
    pc, pn = ported(jc, jn)
    _, sym, rng = noisy_frames(jc, jn, 3, 4, seed=jc.K + t0)
    m0 = np.asarray(jacs.init_metrics(jc, jn, 3)) + rng.integers(0, 40, size=(3, jc.num_states))
    m0 = m0.astype(np.int32)
    jm, jw, joff = jacs.acs_update_rotating(jc, jn, jnp.asarray(m0), jnp.asarray(sym), t0)
    pm, pw, poff = pacs.acs_update_rotating(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym), t0)
    assert pw.shape == (3, sym.shape[1], jc.decision_words) and pw.dtype == torch.int32
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pw.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(poff.numpy(), np.asarray(joff))
    assert (poff > 0).all()  # the interval fired


@pytest.mark.parametrize("jc", CODES)
def test_bytes_through_the_rotated_walk(jc):
    """Whole noisy frames from step 0: the rotated walk over the port's
    words gives the JAX bytes, and the state-order path's bytes."""
    jn = J.soft8_spec(jc.R)
    pc, pn = ported(jc, jn)
    data, sym, _ = noisy_frames(jc, jn, 2, 6, seed=77)
    m0 = np.asarray(jacs.init_metrics(jc, jn, 2))
    _, jw, _ = jacs.acs_update_rotating(jc, jn, jnp.asarray(m0), jnp.asarray(sym), 0)
    want = np.asarray(jcb.chainback(jc, jw, 48, 0, True))
    pm, pw, _ = pacs.acs_update_rotating(pc, pn, torch.from_numpy(m0.copy()), torch.from_numpy(sym))
    got = pcb.chainback(pc, pw, 48, 0, rotated=True)
    np.testing.assert_array_equal(got.numpy(), want)
    m_ref, w_ref, _ = pacs.acs_update(pc, pn, torch.from_numpy(m0.copy()), torch.from_numpy(sym), True)
    assert torch.equal(pm, m_ref)
    assert torch.equal(got, pcb.chainback(pc, w_ref, 48))


def test_words_are_the_inplace_kernels_packing():
    """Position order of step t+1, the packing of ``acs_update_inplace``:
    the plain in-place version on the same frames writes the same words."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    _, sym, _ = noisy_frames(jc, jn, 2, 4, seed=3)
    m0 = pacs.init_metrics(pc, pn, 2)
    pm, pw, _ = pacs.acs_update_rotating(pc, pn, m0, torch.from_numpy(sym))
    T = sym.shape[1]
    m_pos, dec = inplace.acs_update_inplace(pc, pn, m0.T.contiguous(),
                                            torch.from_numpy(sym).permute(1, 2, 0).contiguous(), T, 0)
    assert torch.equal(dec.permute(2, 0, 1), pw)
    back = torch.as_tensor(inplace.rot_perm(pc, T, inverse=True))
    assert torch.equal(m_pos[back].T, pm)
