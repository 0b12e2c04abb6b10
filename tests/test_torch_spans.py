"""The port's named spans (``utils.spans``).

With no profiler running ``span`` is one shared null context and never
enters ``record_function``.  Under ``torch.profiler`` on the CPU (the
``cuda`` backend on a CPU device runs the kernels' plain versions) the
decoders' phases, a push's walk and retained-rows copy, and the buffers'
growth appear as ``user_annotation`` events of the Chrome trace by their
documented names, and a kernel launcher's call (``_build.Bound``, here over
a stand-in library function) as ``ka9q.launch.<counter>`` beside its count
in ``LAUNCHES``.  The spans change no output.
"""

import ctypes
import json
import types

import pytest
import torch

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build
from ka9q_viterbi_comparison_tpu_torch.utils import spans

B = 4


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _annotations(prof, tmp_path) -> list[str]:
    """The names of the trace's ``user_annotation`` events, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: float(e.get("ts", 0)))
            if e.get("cat") == "user_annotation"]


def _symbols(code, steps: int, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-3, 4, (B, steps * code.R), generator=g, dtype=torch.int32)


def _frames(code, device="cpu"):
    """reset -> update -> chainback of one batch of frames; the bytes."""
    dec = P.ViterbiDecoder(code, P.soft8_spec(code.R), batch=B, backend="cuda", device=device)
    dec.reset()
    dec.update(_symbols(code, 64 + code.K - 1))
    return dec.chainback(64)


def _stream(code):
    """Two pushes of a stream whose depth makes both release and retain."""
    dec = P.StreamingDecoder(code, P.soft8_spec(code.R), batch=B, traceback_depth=24,
                             backend="cuda", device="cpu")
    return [dec.push(_symbols(code, 40, seed)) for seed in (1, 2)]


def test_span_is_the_shared_null_context_when_no_profiler_runs(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    first = spans.span("ka9q.update")
    assert first is spans.span("ka9q.launch.chainback_tb")
    with first as entered:
        assert entered is None
    # The decoders' spans take the same path.
    _frames(P.VITERBI27)
    _stream(P.VITERBI27)


@pytest.mark.parametrize("code", [P.VITERBI27, P.VITERBI615], ids=["k7", "k15"])
def test_frame_decoder_phases_are_spans(code, tmp_path):
    want = _frames(code)
    with _profiler() as prof:
        got = _frames(code)
    assert torch.equal(got, want)
    names = _annotations(prof, tmp_path)
    # The constructor resets too.
    assert [n for n in names if n != "ka9q.alloc"] == [
        "ka9q.reset", "ka9q.reset", "ka9q.update", "ka9q.chainback"]
    # The word buffer of the whole-frame routes (K=7 here) grows inside the update.
    assert ("ka9q.alloc" in names) == (code.K <= 9)
    if code.K <= 9:
        assert names.index("ka9q.update") < names.index("ka9q.alloc")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the depth-4 large-K launcher has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_large_k_words_and_offset_are_an_alloc_span(cuda_device, tmp_path):
    """At ICE the depth-4 route makes a call's words and offset inside
    ``ka9q.alloc``, within the update and before its launcher's span."""
    want = _frames(P.VITERBI224, cuda_device)
    with _profiler() as prof:
        got = _frames(P.VITERBI224, cuda_device)
    assert torch.equal(got, want)
    assert _annotations(prof, tmp_path) == [
        "ka9q.reset", "ka9q.reset", "ka9q.update", "ka9q.alloc",
        "ka9q.launch.acs_update_large4", "ka9q.chainback", "ka9q.launch.chainback_tb"]


def test_stream_push_is_a_span_around_its_walk_and_retain(tmp_path):
    want = _stream(P.VITERBI27)
    with _profiler() as prof:
        got = _stream(P.VITERBI27)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # The window is allocated at the first push only.
    assert _annotations(prof, tmp_path) == [
        "ka9q.push", "ka9q.alloc", "ka9q.push.walk", "ka9q.push.retain",
        "ka9q.push", "ka9q.push.walk", "ka9q.push.retain"]


@pytest.fixture
def stand_in_launcher(monkeypatch):
    """``_build.library`` with one stand-in launcher that records its
    arguments and returns the error code it is given."""
    calls, result = [], {"err": 0}

    def fake(*args):
        calls.append(args)
        return result["err"]

    monkeypatch.setattr(_build, "library", lambda: {"viterbi_fake": fake})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    return calls, result


def test_bound_counts_and_spans_each_launch(stand_in_launcher, tmp_path):
    calls, result = stand_in_launcher
    before = _build.LAUNCHES["chainback_tb"]
    bound = _build.Bound("chainback_tb", "viterbi_fake", torch.device("cpu"))
    bound(1, 2)  # no profiler
    with _profiler() as prof:
        bound(3, 4)
    assert [a[:2] for a in calls] == [(1, 2), (3, 4)]
    assert all(a[2].value == 7 for a in calls)  # the stream, last
    assert _build.LAUNCHES["chainback_tb"] == before + 2
    assert _annotations(prof, tmp_path) == ["ka9q.launch.chainback_tb"]

    # A launcher that reports its launches adds what it reported.
    reported, scans = ctypes.c_int(3), _build.LAUNCHES["sharded_acs_scan"]
    _build.Bound("sharded_acs_scan", "viterbi_fake", torch.device("cpu"), reported)()
    assert _build.LAUNCHES["sharded_acs_scan"] == scans + 3
    result["err"] = 700
    with pytest.raises(RuntimeError, match="viterbi_fake: CUDA error 700"):
        bound()
    assert _build.LAUNCHES["chainback_tb"] == before + 2
