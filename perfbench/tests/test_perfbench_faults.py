"""The rest of a run (set-up, window, comparison) on the CPU at a small size,
past the look for a card: sound runs come out correct, and ``correct``
comes out false with the timed path broken underneath -- a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced -- and with the control in the program's place.  One
card, so no exchange between chips to leave out."""

import subprocess
import sys
import time

import pytest
import torch

from ka9q_viterbi_comparison_tpu_torch import StreamingDecoder, ViterbiDecoder
from perfbench import cell, control
from perfbench.tests import small

CPU = torch.device("cpu")
SPECS = {
    "frames": lambda: small.cell_spec(small.config("viterbi27", data_bytes=32), small.frames(batch=8)),
    "large_k": lambda: small.cell_spec(small.config("viterbi615", data_bytes=4), small.frames(batch=2)),
    "stream": lambda: small.cell_spec(small.config("viterbi27"), small.stream(batch=8, push_steps=96)),
}


def _run(kind, seed=3, program=None, calls=None):
    s = SPECS[kind]()
    if calls is None:
        calls = 6 if s.traffic["entry"] == "frames" else 3 * s.traffic["pool"] + 2
    return cell.run(s, seed, 1e9, False, CPU, time.perf_counter(), program=program,
                    max_calls=calls, log=lambda *a: None)


@pytest.mark.parametrize("kind", list(SPECS))
def test_sound_run_is_correct(kind):
    res = _run(kind)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())


def _state_unchanged(monkeypatch, kind):
    if kind == "stream":
        push = StreamingDecoder.push

        def stale(self, symbols):
            before = self.metrics
            out = push(self, symbols)
            self.metrics = before
            return out

        monkeypatch.setattr(StreamingDecoder, "push", stale)
    else:
        update = ViterbiDecoder.update

        def stale(self, symbols):
            before = self.metrics
            update(self, symbols)
            self.metrics = before

        monkeypatch.setattr(ViterbiDecoder, "update", stale)


def _patch_output(monkeypatch, kind, damage):
    cls, name = (StreamingDecoder, "push") if kind == "stream" else (ViterbiDecoder, "chainback")
    orig = getattr(cls, name)

    def broken(self, *args, **kw):
        out = orig(self, *args, **kw)
        damage(out)
        return out

    monkeypatch.setattr(cls, name, broken)


def _half_batch(out):
    out[out.shape[0] // 2:] = 0


def _flip_one(out):
    if out.numel():
        out.view(-1)[out.numel() // 3] ^= 1


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_makes_run_incorrect(kind, fault, monkeypatch):
    if fault == "state_unchanged":
        _state_unchanged(monkeypatch, kind)
    else:
        _patch_output(monkeypatch, kind, _half_batch if fault == "half_batch" else _flip_one)
    res = _run(kind)
    assert not res["correct"] and res["failed"] > 0


CONTROL_SPECS = {
    "frames": lambda: small.cell_spec(small.config("viterbi27", data_bytes=128), small.frames(batch=32)),
    "stream": lambda: small.cell_spec(small.config("viterbi27"), small.stream(batch=32, push_steps=512)),
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind", list(CONTROL_SPECS))
def test_control_is_incorrect(kind, seed):
    """The reference with ties to the high predecessor in the program's
    place, at a size where ties reach the survivors of a few frames."""
    s = CONTROL_SPECS[kind]()
    res = control.run_control(s, seed, CPU)
    assert not res["correct"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "viterbi27.frames_b512", "--seed", "1", "--seconds", "1"],
                          cwd=small.HERE.parent, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout == ""


@pytest.mark.cuda
def test_cell_on_card(cuda_device):
    """A short window of the first cell on the card comes out correct."""
    from perfbench import spec
    s = spec.load("viterbi27.frames_b512")
    res = cell.run(s, 5, 1.0, False, cuda_device, time.perf_counter(), log=lambda *a: None)
    assert res["correct"], res["checks"]
