"""The ICE configuration (``viterbi224``, K=24, 2^23 states) on the CPU at
the smallest frame: noiseless frames decode to their data through the plain
reference; under AWGN the port (``ViterbiDecoder`` on the ``cuda`` backend,
whose CPU path is the depth-4 route's plain version) agrees with it bit for
bit in bytes, in every state's metric with the route's offset added back,
and in every state's decision at every step, as the cell's entry compares
them; the control (ties high) does not.  At one data byte (T = 31) the route
shifts the metrics before its three remainder steps, so the offset is not
zero and is held too.  The ACS bound at the cell's shape reproduces the
port's kernel table."""

import torch

from perfbench import roofline
from perfbench.entries import frames_decisions
from perfbench.reference import channel
from perfbench.reference import viterbi as ref
from perfbench.tests import small

CPU = torch.device("cpu")
NBYTES = 1


def test_noiseless_frame_decodes_to_data():
    code = ref.code_from_config(small.config("viterbi224"))
    data = torch.tensor([[0xA7]], dtype=torch.uint8)
    coded = channel.encode_bits(code, channel.bytes_to_bits(data))
    symbols = torch.where(coded.bool(), code.soft_high, code.soft_low).reshape(1, -1)
    out, metrics = ref.decode_frames(code, symbols, NBYTES)
    assert torch.equal(out, data)
    assert metrics[:, 0].tolist() == [0]


def _entry(program=None):
    return frames_decisions.Entry(small.config("viterbi224", data_bytes=NBYTES),
                                  dict(small.frames(batch=1, pool=1), entry="frames_decisions"),
                                  2**31 + 11, CPU, program)


def _checks(entry):
    """One call kept, the pool decoded once more, both against the
    reference."""
    kept = {0: entry.keep(entry.call(0))}
    final = entry.finish(0)
    entry.program = None
    return entry.check(kept, final)[0], kept[0]


def test_frame_agrees_with_port():
    checks, (_, _, offset) = _checks(_entry())
    assert checks == {"bytes_wrong": 0, "metrics_wrong": 0, "decisions_wrong": 0}
    assert bool((offset != 0).all())


def test_control_is_incorrect():
    # Ties decide some of the 31 x 2^23 decisions; bytes and metrics may agree.
    checks, _ = _checks(_entry(frames_decisions.Control))
    assert checks["decisions_wrong"] > 0


def test_acs_bound_reproduces_kernel_table():
    # The octet ACS at ICE B=8, 8-byte frames (T = 87): 2.0939 ms, by its operations.
    assert round(roofline.acs_bound_s(24, 2, 8, 87) * 1e3, 4) == 2.0939
