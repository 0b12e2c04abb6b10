"""The plain reference: noiseless frames decode to their data, and at small
sizes under AWGN it agrees bit for bit with the port's CPU path (bytes,
every state's path metric, released bits, metrics after each push)."""

import pytest
import torch

from ka9q_viterbi_comparison_tpu_torch import StreamingDecoder, ViterbiDecoder
from perfbench.entries import frames as frames_entry
from perfbench.entries import stream as stream_entry
from perfbench.entries.common import port_specs
from perfbench.reference import channel
from perfbench.reference import viterbi as ref
from perfbench.tests import small

CPU = torch.device("cpu")


@pytest.mark.parametrize("name,nbytes", [("viterbi27", 16), ("viterbi615", 4)])
def test_noiseless_frames_decode_to_data(name, nbytes):
    cfg = small.config(name)
    code = ref.code_from_config(cfg)
    g = torch.Generator().manual_seed(7)
    data = torch.randint(0, 256, (3, nbytes), generator=g, dtype=torch.uint8)
    coded = channel.encode_bits(code, channel.bytes_to_bits(data))
    symbols = torch.where(coded.bool(), code.soft_high, code.soft_low).reshape(3, -1)
    out, metrics = ref.decode_frames(code, symbols, nbytes)
    assert torch.equal(out, data)
    assert metrics[:, 0].tolist() == [0, 0, 0]


@pytest.mark.parametrize("name,nbytes,batch,seed", [
    ("viterbi27", 32, 4, 1),     # the state-order route
    ("viterbi27", 8, 128, 2),    # the in-place route (its plain version)
    ("viterbi615", 4, 2, 3),     # the large-K route
])
def test_frames_agree_with_port(name, nbytes, batch, seed):
    entry = frames_entry.Entry(small.config(name, data_bytes=nbytes), small.frames(batch=batch),
                               seed, CPU, program=lambda e: None)
    code, numeric = port_specs(entry.config)
    for j, symbols in enumerate(entry.pool):
        dec = ViterbiDecoder(code, numeric, batch=batch, backend="cuda", device=CPU)
        dec.update(symbols)
        got = dec.chainback(8 * nbytes)
        want, metrics = ref.decode_frames(entry.code, symbols, nbytes)
        assert torch.equal(got, want)
        port_metrics = dec.metrics.to(torch.int64) + dec.renorm_offset.to(torch.int64)[:, None]
        assert torch.equal(port_metrics, metrics)
        assert torch.equal(dec.path_metric(), metrics[:, 0].to(torch.int32))


@pytest.mark.parametrize("batch,steps,seed", [(4, 64, 4), (130, 32, 5)])
def test_stream_agrees_with_port(batch, steps, seed):
    """Push by push, past the two periods that the reference computes, so
    that its extrapolation is held too (130 streams: the in-place route)."""
    entry = stream_entry.Entry(small.config("viterbi27"),
                               small.stream(batch=batch, push_steps=steps), seed, CPU,
                               program=lambda e: None)
    code, numeric = port_specs(entry.config)
    dec = StreamingDecoder(code, numeric, batch=batch, backend="cuda", device=CPU)
    stream = ref.StreamReference(entry.code, entry.pool, entry.n, entry.depth)
    assert stream.coupled
    pushes = 4 * entry.P + 3
    want = stream.releases(list(range(pushes)))
    for p in range(pushes):
        got = dec.push(entry.chunks[p % entry.P])
        assert torch.equal(got, want[p]), p
        assert torch.equal(dec.metrics.to(torch.int64), stream.metrics_after(p)), p


def test_stream_release_lengths():
    """The first push releases all but the depth and the K-1 warm-up
    outputs; later pushes release a push's worth."""
    entry = stream_entry.Entry(small.config("viterbi27"), small.stream(push_steps=64), 9, CPU,
                               program=lambda e: None)
    stream = ref.StreamReference(entry.code, entry.pool, entry.n, entry.depth)
    rel = stream.releases([0, 1, 7])
    assert rel[0].shape == (4, 64 - 56 - 6)
    assert rel[1].shape == rel[7].shape == (4, 64)


def test_ties_high_changes_only_decisions():
    entry = frames_entry.Entry(small.config("viterbi27", data_bytes=64), small.frames(batch=16),
                               2, CPU, program=lambda e: None)
    a, ma = ref.decode_frames(entry.code, entry.pool[0], 64)
    b, mb = ref.decode_frames(entry.code, entry.pool[0], 64, ties_high=True)
    assert torch.equal(ma, mb)
    assert not torch.equal(a, b)
