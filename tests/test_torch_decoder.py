"""The port's decoder and functional entry points against the JAX package's,
on the CPU: backend ``cuda`` (the kernels' plain versions) and ``torch`` vs
JAX ``pallas`` (interpret mode) and ``jnp``, on both kernel routes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.convert import (
    code_from_fields,
    decoder_state_from_numpy,
    numeric_from_fields,
)
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, flags, large_k2, large_k4
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors

ROUTES = [pytest.param("1", id="inplace"), pytest.param("0", id="state_order")]


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def frames(jc, jn, B, n_bytes, noise, seed):
    """``(data [B, N] uint8, symbols [B, T*R] int32)``: encoded + uniform
    integer noise, clipped to the rails."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data)))
    sym = np.clip(sym + rng.integers(-noise, noise + 1, size=sym.shape), jn.soft_low, jn.soft_high)
    return data, sym.astype(np.int32)


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", request.param)
    monkeypatch.setenv("KA9Q_TPU_INPLACE", request.param)
    return request.param


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_decoder_matches_jax_backends(route):
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    B, n = 4, 16
    assert dispatch.use_inplace(pc, B) == (route == "1")
    data, sym = frames(jc, jn, B, n, 3, seed=1)

    jdec = J.ViterbiDecoder(jc, jn, batch=B, backend="pallas")
    jdec.update(jnp.asarray(sym))
    want = np.asarray(jdec.chainback(n * 8))
    pdec = P.ViterbiDecoder(pc, pn, batch=B, backend="cuda", device="cpu")
    pdec.update(torch.from_numpy(sym))
    got = pdec.chainback(n * 8)
    np.testing.assert_array_equal(got.numpy(), want)
    # Same route, same words: position-packed on the in-place route.
    np.testing.assert_array_equal(pdec._decision_blocks[0].numpy().view(np.uint32),
                                  np.asarray(jdec._decision_blocks[0]))
    np.testing.assert_array_equal(pdec.metrics.numpy(), np.asarray(jdec.metrics))
    np.testing.assert_array_equal(pdec.path_metric(0).numpy(), np.asarray(jdec.path_metric(0)))

    jnp_out = np.asarray(J.decode_frames(jc, jn, jnp.asarray(sym), n * 8, backend="jnp"))
    torch_out = P.decode_frames(pc, pn, torch.from_numpy(sym), n * 8, backend="torch", device="cpu")
    np.testing.assert_array_equal(torch_out.numpy(), jnp_out)
    np.testing.assert_array_equal(torch_out.numpy(), want)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_blockwise_update(route):
    """Uneven blocks whose edges are not multiples of K-1, so the in-place
    route crosses rotation phases between calls."""
    jc, jn = J.VITERBI27, J.soft16_spec(2)
    pc, pn = ported(jc, jn)
    B, n = 3, 16
    data, sym = frames(jc, jn, B, n, 140, seed=2)
    want = np.asarray(J.decode_frames(jc, jn, jnp.asarray(sym), n * 8, backend="pallas"))
    pdec = P.ViterbiDecoder(pc, pn, batch=B, backend="cuda", device="cpu")
    sym3 = sym.reshape(B, -1, 2)
    for lo, hi in ((0, 41), (41, 100), (100, sym3.shape[1])):
        pdec.update(torch.from_numpy(sym3[:, lo:hi]))
    assert pdec._steps == sym3.shape[1]
    np.testing.assert_array_equal(pdec.chainback(n * 8).numpy(), want)
    jdec = J.ViterbiDecoder(jc, jn, batch=B, backend="jnp")
    jdec.update(jnp.asarray(sym))
    np.testing.assert_array_equal(pdec.metrics.numpy(), np.asarray(jdec.metrics))


def test_path_metric_with_renorm():
    jc = J.VITERBI29
    jn = dataclasses.replace(J.soft8_spec(2), renorm_interval=8)
    pc, pn = ported(jc, jn)
    _, sym = frames(jc, jn, 2, 8, 4, seed=3)
    jdec = J.ViterbiDecoder(jc, jn, batch=2, backend="jnp")
    jdec.update(jnp.asarray(sym))
    pdec = P.ViterbiDecoder(pc, pn, batch=2, backend="torch", device="cpu")
    pdec.update(torch.from_numpy(sym))
    np.testing.assert_array_equal(pdec.renorm_offset.numpy(), np.asarray(jdec.renorm_offset))
    for end in (0, 5):
        np.testing.assert_array_equal(pdec.path_metric(end).numpy(),
                                      np.asarray(jdec.path_metric(end)))
    pdec.reset(starting_state=3)
    assert pdec._steps == 0 and pdec.metrics[0, 3] == 0


def test_inplace_route_at_b128_noiseless():
    """The default route at B >= 128 is the in-place pair, on both sides."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    data, sym = frames(jc, jn, 128, 8, 0, seed=4)
    assert flags.inplace_mode() == "auto" and dispatch.use_inplace(pc, 128)
    got = P.decode_frames(pc, pn, torch.from_numpy(sym), 64, backend="cuda", device="cpu")
    assert count_bit_errors(got, data) == 0
    want = np.asarray(J.decode_frames(jc, jn, jnp.asarray(sym), 64, backend="pallas"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_resume_jax_stream_in_port(route):
    """A JAX decoder's half-stream state, carried across as numpy, resumes
    in the port and decodes identically to the whole stream in JAX."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    B, n = 3, 16
    _, sym = frames(jc, jn, B, n, 3, seed=5)
    sym3 = sym.reshape(B, -1, 2)
    half = 61
    jdec = J.ViterbiDecoder(jc, jn, batch=B, backend="pallas")
    jdec.update(jnp.asarray(sym3[:, :half]))
    pdec = P.ViterbiDecoder(pc, pn, batch=B, backend="cuda", device="cpu")
    decoder_state_from_numpy(pdec, np.asarray(jdec.metrics), np.asarray(jdec._decision_blocks[0]),
                             np.asarray(jdec.renorm_offset), jdec._steps)
    pdec.update(torch.from_numpy(sym3[:, half:]))
    jdec.update(jnp.asarray(sym3[:, half:]))
    np.testing.assert_array_equal(pdec.chainback(n * 8).numpy(), np.asarray(jdec.chainback(n * 8)))
    with pytest.raises(ValueError):
        decoder_state_from_numpy(pdec, np.zeros((B, 63), np.int32), np.zeros((B, 0, 2), np.uint32),
                                 np.zeros(B, np.int32), 0)


def test_functional_matches_jax():
    jc, jn = J.VITERBI47, J.soft8_spec(4)
    pc, pn = ported(jc, jn)
    _, sym = frames(jc, jn, 3, 8, 3, seed=6)
    want = np.asarray(J.decode_symbols(jc, jn, jnp.asarray(sym), 64))
    for backend in ("cuda", "torch"):
        got = P.decode_symbols(pc, pn, torch.from_numpy(sym), 64, backend=backend, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    fn = P.decode_fn(pc, pn, 64, device="cpu")
    np.testing.assert_array_equal(fn(sym).numpy(), want)


def test_large_k_routes_to_later_slice(monkeypatch):
    """K=24 (ICE) takes the depth-4 kernel ``acs_update_large4``, as in the
    JAX package; a block shorter than a quad runs wholly on its remainder,
    an ``acs_update_large2`` block."""
    pc, pn = P.VITERBI224, P.soft8_spec(2)
    calls = []
    real = large_k4.acs_update_large4
    monkeypatch.setattr(large_k4, "acs_update_large4",
                        lambda *a, **k: calls.append(a[3].shape) or real(*a, **k))
    dec = P.ViterbiDecoder(pc, pn, batch=1, backend="cuda", device="cpu")
    dec.update(torch.zeros((1, 2, 2), dtype=torch.int32))
    assert calls == [(1, 2, 2)]
    assert dec.metrics.shape == (1, pc.num_states)
    want = large_k2.acs_update_large2(pc, pn, P.ViterbiDecoder(pc, pn, 1, "torch", "cpu").metrics,
                                      torch.zeros((1, 2, 2), dtype=torch.int32))
    assert torch.equal(dec.metrics, want[0]) and torch.equal(dec._decision_blocks[0], want[1])
    with pytest.raises(ValueError):
        P.ViterbiDecoder(pc, pn, batch=1, backend="pallas", device="cpu")


def test_flags_parse(monkeypatch):
    monkeypatch.delenv("KA9Q_TORCH_INPLACE", raising=False)
    assert flags.inplace_mode() == "auto"
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "0")
    assert flags.inplace_mode() == "off"
    assert not dispatch.use_inplace(P.VITERBI27, 512)
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    assert flags.inplace_mode() == "force"
    assert dispatch.use_inplace(P.VITERBI27, 2)
    assert not dispatch.use_inplace(P.CodeSpec("k5", 5, 2, (0o23, 0o35)), 512)
