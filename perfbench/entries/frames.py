"""Batches of tail-terminated frames through ``ViterbiDecoder``: reset,
update of whole frames, chainback.  Traffic keys: ``batch`` frames a call,
a ``pool`` of distinct batches cycled through, ``inflight`` calls queued."""

from __future__ import annotations

import torch

from ka9q_viterbi_comparison_tpu_torch import ViterbiDecoder

from .. import roofline
from ..reference import channel
from ..reference import viterbi as ref
from .common import bit_errors, generator, mismatch, port_specs

__all__ = ["Entry", "Control", "PortFrames"]


class PortFrames:
    """The port's frame decoder, one instance for the caller."""

    def __init__(self, entry: "Entry"):
        code, numeric = port_specs(entry.config)
        self.nbits = 8 * entry.nbytes
        self.dec = ViterbiDecoder(code, numeric, batch=entry.B, backend="cuda",
                                  device=entry.device)

    def __call__(self, symbols: torch.Tensor) -> torch.Tensor:
        dec = self.dec
        dec.reset()
        dec.update(symbols)
        return dec.chainback(self.nbits)

    def state(self) -> tuple:
        """The call's path metrics of every state, ``[B, S]``, and the offset
        renormalisation took from them, ``[B]``."""
        return self.dec.metrics, self.dec.renorm_offset


class Control:
    """``PortFrames``'s calls, computed by the reference with ties high."""

    CALLS_PER_POOL = 2

    def __init__(self, entry: "Entry"):
        self.code, self.nbytes, self._state = entry.code, entry.nbytes, None

    def __call__(self, symbols):
        out, m = ref.decode_frames(self.code, symbols, self.nbytes, ties_high=True)
        self._state = (m, torch.zeros(m.shape[0], dtype=torch.int64, device=m.device))
        return out

    def state(self):
        return self._state


class Entry:
    """Batches of ``batch`` frames of the configuration's size, a pool of
    ``pool`` batches cycled through."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 program=None):
        self.config, self.traffic, self.device = config, traffic, device
        self.code = ref.code_from_config(config)
        self.nbytes = int(config["data_bytes"])
        self.B, self.P = int(traffic["batch"]), int(traffic["pool"])
        g = generator(seed, device)
        self.data = torch.randint(0, 256, (self.P, self.B, self.nbytes), generator=g,
                                  device=device, dtype=torch.uint8)
        self.pool = [channel.awgn(self.code,
                                  channel.encode_bits(self.code, channel.bytes_to_bits(d)),
                                  float(config["ebn0_db"]), g) for d in self.data]
        self.warmup = self.P
        self.program = (program or PortFrames)(self)

    def call(self, n: int) -> torch.Tensor:
        return self.program(self.pool[n % self.P])

    def bits(self, out: torch.Tensor) -> int:
        return 8 * out.numel()

    def keep(self, out: torch.Tensor) -> tuple:
        return (out, *self.program.state())

    def finish(self, last: int):
        return None

    def bounds(self) -> dict:
        """Per call: the least time of its ACS sweep and of its walk."""
        K, R, B = self.code.K, self.code.R, self.B
        T = 8 * self.nbytes + K - 1
        return {"acs": roofline.acs_bound_s(K, R, B, T),
                "walk": roofline.walk_bound_s(B, T, B * self.nbytes)}

    def check(self, kept: dict, final) -> tuple[dict, int, dict]:
        """Each kept call against the reference's decode of its batch:
        bytes, and every state's path metric (with the offset added back)."""
        want = {j: ref.decode_frames(self.code, self.pool[j], self.nbytes)
                for j in sorted({n % self.P for n in kept})}
        bytes_wrong = metrics_wrong = failed = data_errors = 0
        for n, (out, metrics, offset) in kept.items():
            wb, wm = want[n % self.P]
            got_m = metrics.to(torch.int64) + offset.to(torch.int64).reshape(-1, 1)
            eb, em = mismatch(out, wb), mismatch(got_m, wm)
            bytes_wrong, metrics_wrong = bytes_wrong + eb, metrics_wrong + em
            failed += bool(eb or em)
            data_errors += bit_errors(out, self.data[n % self.P])
        info = {"calls_compared": len(kept), "frames_compared": len(kept) * self.B,
                "ber_vs_data": data_errors / (len(kept) * self.B * 8 * self.nbytes)}
        return {"bytes_wrong": bytes_wrong, "metrics_wrong": metrics_wrong}, failed, info
