"""The stream's window: one buffer the update writes into and the walk reads.

``StreamingDecoder`` keeps its history in one ``[Tcap, W, B]`` buffer,
allocated at the first push and grown only when a larger push comes; the
update writes each push's decisions into its rows, the walk takes its end
state from the metrics and writes the released bits itself, and the
retained rows move to the front.  Here, on the CPU (the kernels' plain
versions), push by push against the JAX ``jnp`` stream of
``tests/test_torch_streaming.py`` (the same symbols and push sizes, so the
JAX side compiles nothing new): K=7 on the state-order route and on the
in-place route (``KA9Q_TORCH_INPLACE=1``), K=15 on the large-K route and on
the in-place route; push sizes that are not multiples of K-1 and that grow
the window; a checkpoint restored mid-stream, the JAX one through
``convert``; ``flush`` from state 0 and from the best state.  The ``cuda``
cases run the same on the card.  Tolerance: none (bit-identical).
"""

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.models.streaming import StreamingDecoder as JStream
from ka9q_viterbi_comparison_tpu_torch import convert
from ka9q_viterbi_comparison_tpu_torch.models.streaming import StreamingDecoder
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build
from test_torch_streaming import B, STREAMS, _jax_stream, _jcode, _noisy_stream

ROUTES = {"kernels": None, "inplace": "1"}


def _stream(name, inplace, monkeypatch, device="cpu"):
    if inplace:
        monkeypatch.setenv("KA9Q_TORCH_INPLACE", inplace)
    code, depth = STREAMS[name][:2]
    dec = StreamingDecoder(code, P.soft8_spec(code.R), B, traceback_depth=depth, device=device)
    assert dec._rotated == bool(inplace)
    return dec


def _pushes(name):
    """``(lo, n)`` of each push of the stream's schedule."""
    out, lo = [], 0
    for n in STREAMS[name][2]:
        out.append((lo, n))
        lo += n
    return out


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(STREAMS))
def test_window_releases_match_jax(name, route, monkeypatch):
    """Each push's release equals the JAX stream's; the window is allocated
    once for a push size and grown only by a larger push; its rows are the
    history, which the state-order route checkpoints as the JAX stream
    does."""
    dec = _stream(name, ROUTES[route], monkeypatch)
    code, depth, pushes, endstate, _, ck = STREAMS[name]
    sym = _noisy_stream(name)
    want, _, state = _jax_stream(name)
    grew = 0
    for i, (lo, n) in enumerate(_pushes(name)):
        before = None if dec._buf is None else (dec._buf.data_ptr(), dec._buf.shape[0])
        room = before is not None and before[1] >= dec._len + n
        got = dec.push(sym[:, lo:lo + n])
        np.testing.assert_array_equal(got.numpy(), want[i], err_msg=f"push {i}")
        after = (dec._buf.data_ptr(), dec._buf.shape[0])
        grew += before != after
        if room:
            assert after == before, f"push {i} reallocated a window that had room"
        else:
            assert after[1] >= depth + n, f"push {i} grew the window to {after[1]} steps"
        assert dec._buf.shape[0] % 32 == 0 and dec._buf.shape[0] >= dec._len
        assert torch.equal(dec.history, dec._buf[:dec._len].permute(2, 0, 1))
        if i == ck and not dec._rotated:
            np.testing.assert_array_equal(dec.checkpoint()["history"].numpy().view(np.uint32),
                                          state["history"])
    assert 1 <= grew < len(pushes)
    np.testing.assert_array_equal(dec.flush(endstate).numpy(), want[-1])


@pytest.mark.parametrize("route", list(ROUTES))
def test_push_hands_the_update_its_symbols_where_they_lie(route, monkeypatch):
    """On both K=7 whole-frame routes a push gives the update kernel the
    pushed batch-major symbols as a view (no copy: their own memory, any
    strides) and the window's rows as ``out=``; its releases equal those of
    the same stream fed contiguous ``[n, R, B]`` copies."""
    from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, inplace

    sym = torch.from_numpy(_noisy_stream("k7"))
    seen = []

    def record(fn):
        def update(code, numeric, m, s, t_real, *rest, out=None):
            seen.append((s.data_ptr(), s.stride(), out.data_ptr() if out is not None else None))
            return fn(code, numeric, m, s, t_real, *rest, out=out)
        return update

    def stream_releases(copy):
        dec = _stream("k7", ROUTES[route], monkeypatch)
        out = []
        for lo, n in _pushes("k7"):
            push = sym[:, lo:lo + n]
            out.append(dec.push(push.permute(1, 2, 0).contiguous().permute(2, 0, 1)
                                if copy else push))
        return dec, out

    want = stream_releases(copy=True)[1]
    if ROUTES[route]:
        monkeypatch.setattr(inplace, "acs_update_inplace", record(inplace.acs_update_inplace))
    else:
        real = dispatch._small_k_impl
        monkeypatch.setattr(dispatch, "_small_k_impl", lambda batch: record(real(batch)))
    dec, got = stream_releases(copy=False)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(seen) == len(STREAMS["k7"][2])
    base = sym.data_ptr()
    for (ptr, stride, out_ptr), (lo, n) in zip(seen, _pushes("k7")):
        assert ptr == base + 4 * lo * sym.stride(1)  # the pushed symbols' own memory
        assert stride == (sym.stride(1), sym.stride(2), sym.stride(0))
        assert out_ptr is not None


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(STREAMS))
def test_checkpoint_restores_the_window_mid_stream(name, route, monkeypatch):
    """A checkpoint taken mid-stream, restored on a fresh decoder and on one
    whose window is larger, continues with the JAX stream's releases; the
    restored metrics and history are the checkpoint's."""
    code, depth, pushes, endstate, _, ck = STREAMS[name]
    sym = _noisy_stream(name)
    want, _, _ = _jax_stream(name)
    dec = _stream(name, ROUTES[route], monkeypatch)
    for lo, n in _pushes(name)[:ck + 1]:
        dec.push(sym[:, lo:lo + n])
    state = dec.checkpoint()
    used = _stream(name, ROUTES[route], monkeypatch)
    used.push(sym[:, :200])  # a window larger than the checkpoint's
    for fresh in (_stream(name, ROUTES[route], monkeypatch), used):
        fresh.restore(state)
        assert torch.equal(fresh.metrics, state["metrics"])
        assert torch.equal(fresh.history, state["history"])
        for i, (lo, n) in enumerate(_pushes(name)[ck + 1:], start=ck + 1):
            np.testing.assert_array_equal(fresh.push(sym[:, lo:lo + n]).numpy(), want[i])
        np.testing.assert_array_equal(fresh.flush(endstate).numpy(), want[-1])


@pytest.mark.parametrize("name", list(STREAMS))
def test_jax_checkpoint_fills_the_window(name):
    """The JAX stream's checkpoint, converted, refills the state-order
    window and continues with the JAX releases."""
    code, depth, _, endstate, _, ck = STREAMS[name]
    sym = _noisy_stream(name)
    want, _, state = _jax_stream(name)
    dec = StreamingDecoder(code, P.soft8_spec(code.R), B, traceback_depth=depth, device="cpu")
    dec.restore(convert.streaming_checkpoint_from_jax(state, device="cpu"))
    assert dec._buf.shape[0] >= depth and dec._len == state["history"].shape[1]
    for i, (lo, n) in enumerate(_pushes(name)[ck + 1:], start=ck + 1):
        np.testing.assert_array_equal(dec.push(sym[:, lo:lo + n]).numpy(), want[i])
    np.testing.assert_array_equal(dec.flush(endstate).numpy(), want[-1])


def _jax_flushes(name):
    """The JAX stream's flush from state 0 and from its best state, after
    every push of the schedule."""
    import jax.numpy as jnp

    code, depth = STREAMS[name][:2]
    sym = _noisy_stream(name)
    dec = JStream(_jcode(code), J.soft8_spec(code.R), B, traceback_depth=depth, backend="jnp")
    for lo, n in _pushes(name):
        dec.push(jnp.asarray(sym[:, lo:lo + n]))
    state = dec.checkpoint()
    zero = np.asarray(dec.flush(0))
    dec.restore(state)
    return zero, np.asarray(dec.flush(None))


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(STREAMS))
def test_flush_from_state_0_and_from_the_best_state(name, route, monkeypatch):
    """``flush(0)`` walks from an int end state, ``flush(None)`` from the
    argmin of the metrics, which the walk takes itself (in position space
    on the in-place route)."""
    sym = _noisy_stream(name)
    want_zero, want_best = _jax_flushes(name)
    dec = _stream(name, ROUTES[route], monkeypatch)
    for lo, n in _pushes(name):
        dec.push(sym[:, lo:lo + n])
    state = dec.checkpoint()
    np.testing.assert_array_equal(dec.flush(0).numpy(), want_zero)
    assert dec.flush(0).shape == (B, 0)
    dec.restore(state)
    np.testing.assert_array_equal(dec.flush(None).numpy(), want_best)


def test_metrics_cross_in_state_order(monkeypatch):
    """On the in-place route the stream keeps its metrics in position space
    of the head's phase; ``metrics`` reads them in state order and setting
    them back changes nothing that is released."""
    name = "k7"
    sym = _noisy_stream(name)
    want, _, _ = _jax_stream(name)
    rot, ref = (_stream(name, "1", monkeypatch),
                StreamingDecoder(P.VITERBI27, P.soft8_spec(2), B, STREAMS[name][1],
                                 backend="torch", device="cpu"))
    for i, (lo, n) in enumerate(_pushes(name)):
        assert rot.abs_step % 6 == ref.abs_step % 6
        np.testing.assert_array_equal(rot.push(sym[:, lo:lo + n]).numpy(), want[i])
        ref.push(sym[:, lo:lo + n])
        m = rot.metrics
        rot.metrics = m
        assert torch.equal(rot.metrics, m)
        # The kernels carry no renormalisation: the metrics differ from the
        # torch stream's by one shift a frame.
        d = rot.metrics - ref.metrics
        assert torch.equal(d, d[:, :1].expand_as(d))


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", list(STREAMS))
def test_cuda_window_matches_jax(name, route, cuda_device, monkeypatch):
    """The same schedule on the card: the JAX releases push by push, one
    update and (where a push releases bits) one walk launch a push on the
    whole-frame kernels' routes, a checkpoint restored mid-stream, both
    flushes."""
    code, depth, pushes, endstate, _, ck = STREAMS[name]
    sym = torch.from_numpy(_noisy_stream(name)).to(cuda_device)
    want, _, _ = _jax_stream(name)
    want_zero, want_best = _jax_flushes(name)
    dec = _stream(name, ROUTES[route], monkeypatch, cuda_device)
    update, walk = (("acs_update_inplace", "chainback_inplace") if dec._rotated else
                    ("acs_update_tb", "chainback_tb"))
    for i, (lo, n) in enumerate(_pushes(name)):
        _build.reset_launch_counts()
        got = dec.push(sym[:, lo:lo + n])
        if dec._native:
            assert _build.LAUNCHES[update] == 1 and _build.LAUNCHES[walk] == int(got.shape[1] > 0)
        np.testing.assert_array_equal(got.cpu().numpy(), want[i])
        if i == ck:
            state = dec.checkpoint()
    end = dec.checkpoint()
    np.testing.assert_array_equal(dec.flush(0).cpu().numpy(), want_zero)
    dec.restore(end)
    np.testing.assert_array_equal(dec.flush(None).cpu().numpy(), want_best)
    dec.restore(state)
    for i, (lo, n) in enumerate(_pushes(name)[ck + 1:], start=ck + 1):
        np.testing.assert_array_equal(dec.push(sym[:, lo:lo + n]).cpu().numpy(), want[i])
    np.testing.assert_array_equal(dec.flush(endstate).cpu().numpy(), want[-1])
