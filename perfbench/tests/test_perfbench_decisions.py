"""The ``frames_decisions`` entry on the CPU at a small Cassini size: the
words' packing and its count, a sound run correct with every decision
compared, and ``correct`` false with the control in the program's place
(ties high: its bytes and metrics may all agree, its decisions do not) and
with one decision bit of the port's words flipped."""

import time

import pytest
import torch

from perfbench import cell, control
from perfbench.entries import frames_decisions as fd
from perfbench.tests import small

CPU = torch.device("cpu")


def _spec(batch=2, pool=2):
    traffic = dict(small.frames(batch=batch, pool=pool), entry="frames_decisions")
    return small.cell_spec(small.config("viterbi615", data_bytes=4), traffic)


def _run(seed=3, calls=6):
    return cell.run(_spec(), seed, 1e9, False, CPU, time.perf_counter(), max_calls=calls,
                    log=lambda *a: None)


def test_pack_and_mismatch():
    g = torch.Generator().manual_seed(5)
    dec = torch.rand((7, 3, 64), generator=g) < 0.5
    words = fd.pack(dec)
    assert words.shape == (3, 7, 2) and words.dtype == torch.int32
    # Bit s % 32 of word s // 32, the uint32 pattern.
    t, b, s = 4, 1, 37
    assert bool((words[b, t, s // 32] >> (s % 32)) & 1) == bool(dec[t, b, s])
    assert fd.decision_mismatch(words, dec) == 0
    words[2, 5, 1] ^= 1 << 31
    assert fd.decision_mismatch(words, dec) == 1
    assert fd.decision_mismatch(words[:, :6], dec) == dec.numel()


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0
    assert set(res["checks"]) == {"bytes_wrong", "metrics_wrong", "decisions_wrong"}
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())


def test_one_flipped_decision_makes_run_incorrect(monkeypatch):
    words = fd.PortFrames.words

    def flipped(self):
        out = words(self).clone()
        out[0, 3, 0] ^= 1
        return out

    monkeypatch.setattr(fd.PortFrames, "words", flipped)
    res = _run()
    assert not res["correct"]
    assert res["checks"]["decisions_wrong"]["value"] == 2  # one a pool batch
    assert res["checks"]["bytes_wrong"]["value"] == res["checks"]["metrics_wrong"]["value"] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_incorrect(seed):
    """The reference with ties to the high predecessor in the program's
    place: its decisions differ wherever a tie fell."""
    res = control.run_control(_spec(), seed, CPU)
    assert not res["correct"] and res["checks"]["decisions_wrong"]["value"] > 0
