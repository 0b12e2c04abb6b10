"""Unbounded streams through ``StreamingDecoder.push`` at the decoder's
default traceback depth (8 K steps).  Traffic keys: ``batch`` streams,
``push_steps`` trellis steps a push, a ``pool`` of pushes a stream,
``inflight`` pushes queued."""

from __future__ import annotations

import torch

from ka9q_viterbi_comparison_tpu_torch import StreamingDecoder

from .. import roofline
from ..reference import channel
from ..reference import viterbi as ref
from .common import generator, mismatch, port_specs

__all__ = ["Entry", "Control", "PortStream"]


class PortStream:
    """The port's stream decoder: one ``StreamingDecoder`` for all streams."""

    def __init__(self, entry: "Entry"):
        code, numeric = port_specs(entry.config)
        self.dec = StreamingDecoder(code, numeric, batch=entry.B, backend="cuda",
                                    device=entry.device)

    def push(self, symbols: torch.Tensor) -> torch.Tensor:
        return self.dec.push(symbols)

    def final_metrics(self) -> torch.Tensor:
        return self.dec.metrics


class Control:
    """``PortStream``'s pushes, released by the reference with ties high."""

    CALLS_PER_POOL = 3

    def __init__(self, entry: "Entry"):
        self.stream = ref.StreamReference(entry.code, entry.pool, entry.n, entry.depth,
                                          ties_high=True)
        self.p = 0

    def push(self, symbols):
        out = self.stream.releases([self.p])[self.p]
        self.p += 1
        return out

    def final_metrics(self):
        return self.stream.metrics_after(self.p - 1)


class Entry:
    """``batch`` unbounded streams, ``push_steps`` trellis steps a push.  The
    pool is one continuous encoding of ``pool`` pushes a stream whose last
    K-1 data bits are zero, so the encoder is back in state 0 where the pool
    wraps and the streams repeat it without a seam."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 program=None):
        self.config, self.traffic, self.device = config, traffic, device
        self.code = code = ref.code_from_config(config)
        self.B, self.P = int(traffic["batch"]), int(traffic["pool"])
        self.n = int(traffic["push_steps"])
        # The release rule's depth: the decoder's documented default, 8 K steps.
        self.depth = 8 * code.K
        g = generator(seed, device)
        self.data = torch.randint(0, 2, (self.B, self.P * self.n), generator=g, device=device,
                                  dtype=torch.uint8)
        self.data[:, -(code.K - 1):] = 0
        self.pool = channel.awgn(code, channel.encode_bits(code, self.data, tail=False),
                                 float(config["ebn0_db"]), g)
        w = self.n * code.R
        self.chunks = [self.pool[:, i * w:(i + 1) * w] for i in range(self.P)]
        self.warmup = 3
        self.program = (program or PortStream)(self)

    def call(self, n: int) -> torch.Tensor:
        return self.program.push(self.chunks[n % self.P])

    def bits(self, out: torch.Tensor) -> int:
        return out.numel()

    def keep(self, out: torch.Tensor) -> tuple:
        return (out,)

    def finish(self, last: int):
        """The metrics after the last push, and its index."""
        return self.program.final_metrics(), last

    def bounds(self) -> dict:
        """Per push: the ACS sweep over its steps, and the walk over the
        window (the retained depth and the push) from the argmin of the
        metrics, writing a byte a released bit."""
        K, R, B, S = self.code.K, self.code.R, self.B, self.code.S
        return {"acs": roofline.acs_bound_s(K, R, B, self.n),
                "walk": roofline.walk_bound_s(B, self.n + self.depth, B * self.n, 4 * B * S)}

    def check(self, kept: dict, final) -> tuple[dict, int, dict]:
        """Each kept push's released bits, and the metrics after the last
        push, against the reference stream."""
        stream = ref.StreamReference(self.code, self.pool, self.n, self.depth)
        want = stream.releases(sorted(kept))
        bits_wrong = failed = data_errors = nbits = 0
        for p, (out,) in kept.items():
            e = mismatch(out, want[p])
            bits_wrong += e
            failed += bool(e)
            a, b = stream.span(stream.mapped(p)[0])
            idx = torch.arange(a, b, device=self.data.device) - (self.code.K - 1)
            idx = idx % (self.P * self.n)
            truth = self.data[:, idx]
            if tuple(out.shape) == tuple(truth.shape):
                data_errors += int((out.to(truth.device) != truth).sum())
            nbits += truth.numel()
        metrics, last = final
        metrics_wrong = mismatch(metrics.to(torch.int64), stream.metrics_after(last))
        failed += bool(metrics_wrong)
        info = {"pushes_compared": len(kept), "last_push": last, "coupled": stream.coupled,
                "ber_vs_data": data_errors / max(1, nbits),
                "least_metric_per_step": float(metrics.min()) / ((last + 1) * self.n)}
        return {"bits_wrong": bits_wrong, "metrics_wrong": metrics_wrong}, failed, info
