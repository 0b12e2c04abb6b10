"""The port's ka9q-exact and SPIRAL-exact u8 replicas against the JAX ones.

K=7 (v27) and K=9 (v29) on u8 offset-binary streams: encoded frames plus
uniform integer noise of several amplitudes, heavy noise included, clipped
to 0..255.  Final metrics, decision words and decoded bytes must be
identical (tolerance: none).  The SPIRAL renormalisation must have fired on
the heavy stream: with its threshold lifted out of reach the port's metrics
come out different."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import quantized as jq
from ka9q_viterbi_comparison_tpu_torch.ops import quantized as pq
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames

B, N_BYTES = 4, 48
NOISE = [0, 60, 127, 255]  # uniform amplitude; 255: the symbols are all noise
CODES = {"v27": (P.VITERBI27, J.VITERBI27), "v29": (P.VITERBI29, J.VITERBI29)}
FAMILIES = {
    "ka9q": (pq.quantized_update, jq.quantized_update, pq.decode_symbols_ka9q,
             jq.decode_symbols_ka9q),
    "spiral": (pq.spiral_update, jq.spiral_update, pq.decode_symbols_spiral,
               jq.decode_symbols_spiral),
}


def _stream(code, noise, seed=0):
    rng = np.random.default_rng(seed + noise)
    data = rng.integers(0, 256, size=(B, N_BYTES), dtype=np.uint8)
    clean = encode_frames(code, P.ka9q_offset_binary_spec(), torch.from_numpy(data)).numpy()
    sym = np.clip(clean + rng.integers(-noise, noise + 1, size=clean.shape), 0, 255)
    return data, sym.astype(np.uint8)


@pytest.mark.parametrize("name", list(CODES))
def test_branch_tables_equal_jax(name):
    pc, jc = CODES[name]
    assert pq.ka9q_branch_tables(pc) == jq.ka9q_branch_tables(jc)
    assert pq._spiral_branch_tables(pc) == jq._spiral_branch_tables(jc)
    assert pq.SPIRAL_RENORM_THRESHOLD == jq.SPIRAL_RENORM_THRESHOLD
    m = pq.init_metrics_u8(pc, 3, 5, device="cpu")
    np.testing.assert_array_equal(m.numpy(), np.asarray(jq.init_metrics_u8(jc, 3, 5)))


@pytest.mark.parametrize("noise", NOISE)
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("name", list(CODES))
def test_replica_equals_jax(name, family, noise):
    pc, jc = CODES[name]
    p_update, j_update, p_decode, j_decode = FAMILIES[family]
    data, sym = _stream(pc, noise)
    sym3 = sym.reshape(B, -1, 2)
    m_j, w_j = j_update(jc, jq.init_metrics_u8(jc, B), jnp.asarray(sym3))
    m_p, w_p = p_update(pc, pq.init_metrics_u8(pc, B, device="cpu"), torch.from_numpy(sym3))
    assert m_p.dtype == torch.uint8 and w_p.shape == w_j.shape
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(w_p.contiguous().numpy().view(np.uint32), np.asarray(w_j))
    want = np.asarray(j_decode(jc, jnp.asarray(sym), N_BYTES * 8))
    got = p_decode(pc, sym, N_BYTES * 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if noise == 0:
        np.testing.assert_array_equal(got.numpy(), data)


@pytest.mark.parametrize("name", list(CODES))
def test_spiral_renormalisation_fired(name, monkeypatch):
    pc, jc = CODES[name]
    _, sym = _stream(pc, NOISE[-1])
    sym3 = torch.from_numpy(sym.reshape(B, -1, 2))
    m0 = pq.init_metrics_u8(pc, B, device="cpu")
    m, w = pq.spiral_update(pc, m0, sym3)
    monkeypatch.setattr(pq, "SPIRAL_RENORM_THRESHOLD", 255)  # a u8 metric never exceeds it
    m_off, w_off = pq.spiral_update(pc, m0, sym3)
    assert not torch.equal(m, m_off)
    m_j, _ = jq.spiral_update(jc, jq.init_metrics_u8(jc, B), jnp.asarray(sym.reshape(B, -1, 2)))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))


def test_u8_decode_takes_the_canonical_walk_at_any_batch(monkeypatch):
    """Forcing the in-place route (position-packed words for the decoder)
    leaves the replicas' canonical walk alone."""
    pc, jc = CODES["v27"]
    _, sym = _stream(pc, 60, seed=9)
    want = np.asarray(jq.decode_symbols_ka9q(jc, jnp.asarray(sym), N_BYTES * 8))
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    got = pq.decode_symbols_ka9q(pc, sym, N_BYTES * 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_ka9q_mode_refuses_codes_it_cannot_pair():
    with pytest.raises(ValueError, match="rate-1/2"):
        pq.ka9q_branch_tables(P.VITERBI47)
    with pytest.raises(ValueError, match="both register ends"):
        pq.ka9q_branch_tables(P.CodeSpec("k7odd", 7, 2, (0o154, 0o117)))
