"""The port's ``StreamingDecoder`` against the JAX package's.

The five cases of ``tests/test_streaming.py`` on the port, then noisy K=7
and K=15 streams released push by push on the port's three routes
(``backend="torch"``, ``backend="cuda"`` on the CPU -- the kernels' plain
versions, state-order history -- and the same with
``KA9Q_TORCH_INPLACE=1``, position-packed history), each held bit-identical
to the JAX ``StreamingDecoder(backend="jnp")`` on the same symbols: its
routes agree with one another by its own test.  The schedules cover a first
push shorter than K-1 that releases nothing, push sizes that are not
multiples of K-1, the warm-up skip spread over two pushes (K=15) and both
kinds of flush.  A JAX checkpoint resumes in the port through
``convert.streaming_checkpoint_from_jax``.  Tolerance: none (bit-identical).

The JAX side compiles one program a push shape, so each stream uses three
push sizes and runs once per module.
"""

import functools

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.models.streaming import StreamingDecoder as JStream
from ka9q_viterbi_comparison_tpu_torch import convert
from ka9q_viterbi_comparison_tpu_torch.models.streaming import StreamingDecoder
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.utils.bits import bits_to_bytes, count_bit_errors

B = 2
# name -> (code, traceback depth, push sizes in steps, flush end state, frame bytes,
#          index of the push after which the JAX checkpoint is taken)
STREAMS = {
    "k7": (P.VITERBI27, 20, (4, 25, 25, 60, 4, 60, 25, 60), None, 33, 3),
    # 8*25 + 14 = 214 steps, all pushed: tail-terminated, flushed from state 0.
    "k15": (P.VITERBI615, 30, (5, 33, 69, 33, 69, 5), 0, 25, 2),
}
ROUTES = {"torch": ("torch", None), "cuda": ("cuda", None), "cuda-rotated": ("cuda", "1")}


def _jcode(code):
    return {c.name: c for c in J.STANDARD_CODES}[code.name]


def _decode_stream(dec, syms, chunk_syms):
    parts = [dec.push(syms[:, i:i + chunk_syms]) for i in range(0, syms.shape[1], chunk_syms)]
    parts.append(dec.flush(endstate=0))
    return torch.cat(parts, dim=1)


def _frames(code, numeric, n_bytes, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    return data, encode_frames(code, numeric, torch.from_numpy(data))


@functools.lru_cache(maxsize=None)
def _noisy_stream(name):
    """The stream's noisy symbols ``[B, T, R]`` int32 (numpy), encoded frames
    plus uniform integer noise, clipped to the rails."""
    code, _, _, _, n_bytes, _ = STREAMS[name]
    numeric = P.soft8_spec(code.R)
    rng = np.random.default_rng(2026)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    clean = encode_frames(code, numeric, torch.from_numpy(data)).numpy()
    sym = np.clip(clean + rng.integers(-3, 4, size=clean.shape), numeric.soft_low,
                  numeric.soft_high).astype(np.int32)
    return sym.reshape(B, -1, code.R)


@functools.lru_cache(maxsize=None)
def _jax_stream(name):
    """The JAX ``jnp`` stream: the bits each push released, the flush's, the
    final metrics and the checkpoint after push ``ck`` (numpy)."""
    import jax.numpy as jnp

    code, depth, pushes, endstate, _, ck = STREAMS[name]
    sym = _noisy_stream(name)
    dec = JStream(_jcode(code), J.soft8_spec(code.R), B, traceback_depth=depth, backend="jnp")
    outs, lo, state = [], 0, None
    for i, n in enumerate(pushes):
        outs.append(np.asarray(dec.push(jnp.asarray(sym[:, lo:lo + n]))))
        lo += n
        if i == ck:
            state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
                     for k, v in dec.checkpoint().items()}
    outs.append(np.asarray(dec.flush(endstate)))
    return outs, np.asarray(dec.metrics), state


def _port_stream(name, dec, start=0):
    code, _, pushes, endstate, _, _ = STREAMS[name]
    sym = _noisy_stream(name)
    lo = sum(pushes[:start])
    outs = []
    for n in pushes[start:]:
        outs.append(dec.push(sym[:, lo:lo + n]).cpu().numpy())
        lo += n
    outs.append(dec.flush(endstate).cpu().numpy())
    return outs


# -- the five cases of tests/test_streaming.py --

def test_streaming_matches_batch(rng):
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    data, syms = _frames(code, numeric, 256, 1234)
    dec = StreamingDecoder(code, numeric, batch=2, device="cpu")
    bits = _decode_stream(dec, syms, chunk_syms=50 * code.R)
    assert count_bit_errors(bits_to_bytes(bits[:, :256 * 8]), data) == 0


def test_streaming_emits_with_bounded_latency(rng):
    """Bits must flow before the stream ends, not only at flush."""
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    _, syms = _frames(code, numeric, 256, 5)
    dec = StreamingDecoder(code, numeric, batch=2, traceback_depth=64, device="cpu")
    released = dec.push(syms[:, :200 * code.R])
    assert 0 < released.shape[1] <= 200


def test_checkpoint_resume_bit_exact(rng):
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    data, syms = _frames(code, numeric, 128, 6)
    half = (syms.shape[1] // (2 * code.R)) * code.R
    d0 = StreamingDecoder(code, numeric, batch=2, device="cpu")
    bits_a = d0.push(syms[:, :half])
    ckpt = d0.checkpoint()
    d1 = StreamingDecoder(code, numeric, batch=2, device="cpu")
    d1.restore(ckpt)
    bits = torch.cat([bits_a, d1.push(syms[:, half:]), d1.flush(endstate=0)], dim=1)
    assert count_bit_errors(bits_to_bytes(bits[:, :128 * 8]), data) == 0


def test_streaming_cuda_backend_matches_torch(rng, monkeypatch):
    """The kernels' route (their plain versions here) is bit-identical to the
    portable route, through the in-place kernel's position-packed words too
    (rotation phases kept across pushes by ``t0``)."""
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    data, syms = _frames(code, numeric, 128, 7)
    ref = _decode_stream(StreamingDecoder(code, numeric, 2, backend="torch", device="cpu"),
                         syms, 64 * code.R)
    dec = StreamingDecoder(code, numeric, 2, backend="cuda", device="cpu")
    assert not dec._rotated
    assert torch.equal(_decode_stream(dec, syms, 64 * code.R), ref)
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    dec = StreamingDecoder(code, numeric, 2, backend="cuda", device="cpu")
    assert dec._rotated
    bits = _decode_stream(dec, syms, 64 * code.R)
    assert torch.equal(bits, ref)
    assert count_bit_errors(bits_to_bytes(bits[:, :128 * 8]), data) == 0


def test_restore_refuses_mismatched_history_packing(rng, monkeypatch):
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    rot = StreamingDecoder(code, numeric, 2, backend="cuda", device="cpu")
    assert rot._rotated
    _, syms = _frames(code, numeric, 32, 8)
    rot.push(syms[:, :60 * code.R])
    state = rot.checkpoint()
    assert state["rotated_history"] is True
    plain = StreamingDecoder(code, numeric, 2, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="packing"):
        plain.restore(state)
    rot2 = StreamingDecoder(code, numeric, 2, backend="cuda", device="cpu")
    rot2.restore(state)
    assert rot2.abs_step == rot.abs_step
    assert torch.equal(rot2.history, rot.history)


# -- against the JAX package --

@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(STREAMS))
def test_push_by_push_matches_jax(name, route, monkeypatch):
    code, depth, pushes, _, _, _ = STREAMS[name]
    backend, inplace = ROUTES[route]
    if inplace:
        monkeypatch.setenv("KA9Q_TORCH_INPLACE", inplace)
    dec = StreamingDecoder(code, P.soft8_spec(code.R), B, traceback_depth=depth,
                           backend=backend, device="cpu")
    assert dec._rotated == bool(inplace)
    want, want_metrics, _ = _jax_stream(name)
    got = _port_stream(name, dec)
    assert [g.shape for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"release {i} of {len(pushes) + 1}")
    if backend == "torch":  # the one route whose metrics carry no shift
        np.testing.assert_array_equal(dec.metrics.numpy(), want_metrics)


@pytest.mark.parametrize("route", ["torch", "cuda"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_jax_checkpoint_resumes_in_the_port(name, route):
    """The JAX stream's checkpoint, converted, continues in the port with the
    JAX stream's own later releases; the port's checkpoint of the same state
    has the JAX layout and words."""
    code, depth, _, _, _, ck = STREAMS[name]
    want, _, state = _jax_stream(name)
    dec = StreamingDecoder(code, P.soft8_spec(code.R), B, traceback_depth=depth,
                           backend=route, device="cpu")
    dec.restore(convert.streaming_checkpoint_from_jax(state, device="cpu"))
    mine = dec.checkpoint()
    assert set(mine) == set(state)
    assert mine["history"].shape == state["history"].shape  # [B, h, W]
    np.testing.assert_array_equal(mine["history"].numpy().view(np.uint32), state["history"])
    got = _port_stream(name, dec, start=ck + 1)
    for g, w in zip(got, want[ck + 1:], strict=True):
        np.testing.assert_array_equal(g, w)


def test_jax_checkpoint_packing_is_checked(monkeypatch):
    """A JAX checkpoint of state-order history is refused by a port stream
    that position-packs, and a wrongly sized one by any stream."""
    _, _, state = _jax_stream("k7")
    code, depth = STREAMS["k7"][:2]
    ported = convert.streaming_checkpoint_from_jax(state, device="cpu")
    assert ported["rotated_history"] is False
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    rot = StreamingDecoder(code, P.soft8_spec(2), B, traceback_depth=depth, device="cpu")
    with pytest.raises(ValueError, match="packing"):
        rot.restore(ported)
    other = StreamingDecoder(code, P.soft8_spec(2), B + 1, backend="torch", device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        other.restore(ported)


def test_streaming_example_runs_on_the_cpu(capsys):
    from ka9q_viterbi_comparison_tpu_torch.examples import streaming_decode

    streaming_decode.main(["--device", "cpu"])
    assert "decoded correctly: True" in capsys.readouterr().out


# -- on the card: the stream through the kernels equals the JAX stream --------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inplace", ["0", "1"])
@pytest.mark.parametrize("name", list(STREAMS))
def test_cuda_stream_matches_jax(name, inplace, cuda_device, monkeypatch):
    """Both routes on the card, their launches counted, release the JAX
    stream's bits push by push."""
    from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("KA9Q_TORCH_INPLACE", inplace)
    code, depth = STREAMS[name][:2]
    dec = StreamingDecoder(code, P.soft8_spec(code.R), B, traceback_depth=depth)
    assert dec._rotated == (inplace == "1")
    _build.reset_launch_counts()
    got = _port_stream(name, dec)
    walk = "chainback_inplace" if dec._rotated else "chainback_tb"
    assert _build.LAUNCHES[walk] > 0
    want, _, _ = _jax_stream(name)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
