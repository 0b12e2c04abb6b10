"""Tail-terminated frames through ``ViterbiDecoder``, as ``frames``, with
the program's decision words held to the reference's decisions as well.

``frames`` compares each kept call's bytes and every state's final metric.
A tie changes no metric, and at a few bit errors a call it seldom reaches
the decoded path, so those two let a program that breaks the tie rule pass;
every state's decision at every step shows it.  Once the window has closed,
the program decodes each batch of the pool once more and its decision words
are kept (the window keeps none: at 2^23 states a call's words are 730 MB);
``check`` compares them bit for bit with the reference's decisions on the
same batch, as ``decisions_wrong``.

The words are those of the port's state-order routes (K >= 10, off the
whole-frame kernels): ``[B, T, S/32]`` int32, bit ``s % 32`` of word
``s // 32`` set where state ``s``'s predecessor ``(s >> 1) + S/2`` won."""

from __future__ import annotations

import torch

from ..reference import viterbi as ref
from . import frames
from .common import bit_errors, mismatch

__all__ = ["Entry", "Control", "PortFrames", "decode", "pack", "decision_mismatch"]


def decode(code: ref.Code, symbols: torch.Tensor, data_bytes: int,
           ties_high: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ref.decode_frames``, keeping its decisions: (bytes ``[B,
    data_bytes]`` uint8, metrics ``[B, S]`` int64, decisions ``[T, B, S]``
    bool)."""
    B = symbols.shape[0]
    T = 8 * data_bytes + code.K - 1
    pen = ref.pattern_penalties(code, symbols.reshape(B, T, code.R)).transpose(0, 1).contiguous()
    dec = torch.empty((T, B, code.S), dtype=torch.bool, device=symbols.device)
    m = ref.acs(code, ref.init_metrics(code, B, symbols.device), pen, dec, ties_high)
    del pen
    ends = torch.tensor([T], device=symbols.device)
    zero = torch.zeros((1, B), dtype=torch.int64, device=symbols.device)
    bits = ref.walk(code, dec, ends, zero, 0, 8 * data_bytes)[0]
    return ref.bits_to_bytes(bits), m, dec


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack(dec: torch.Tensor) -> torch.Tensor:
    """Decisions ``[T, B, S]`` bool -> words ``[B, T, S/32]`` int32 (the
    uint32 pattern), a step at a time."""
    T, B, S = dec.shape
    words = torch.empty((B, T, S // 32), dtype=torch.int32, device=dec.device)
    weight = 1 << _shifts(dec.device)
    for t in range(T):
        w = (dec[t].reshape(B, S // 32, 32).to(torch.int64) * weight).sum(-1)
        words[:, t] = torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)
    return words


def decision_mismatch(words: torch.Tensor, dec: torch.Tensor) -> int:
    """States and steps whose decision in ``words [B, T, S/32]`` differs
    from ``dec [T, B, S]``; all of them where the shapes differ."""
    T, B, S = dec.shape
    if tuple(words.shape) != (B, T, S // 32):
        return dec.numel()
    words, shifts = words.to(dec.device, torch.int64), _shifts(dec.device)
    wrong = 0
    for t in range(T):
        bits = ((words[:, t, :, None] >> shifts) & 1).bool().reshape(B, S)
        wrong += int((bits != dec[t]).sum())
    return wrong


class PortFrames(frames.PortFrames):
    """``frames.PortFrames``, whose last call's decision words are read."""

    def words(self) -> torch.Tensor:
        blocks = self.dec._decision_blocks  # the decoder's history, as convert.py loads it
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)


class Control(frames.Control):
    """``frames.Control``, whose words are the ties-high reference's
    decisions."""

    def __call__(self, symbols):
        out, m, self._dec = decode(self.code, symbols, self.nbytes, ties_high=True)
        self._state = (m, torch.zeros(m.shape[0], dtype=torch.int64, device=m.device))
        return out

    def words(self) -> torch.Tensor:
        return pack(self._dec)


class Entry(frames.Entry):
    """``frames.Entry``, with ``PortFrames`` above as its program."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 program=None):
        super().__init__(config, traffic, seed, device, program or PortFrames)

    def finish(self, last: int) -> dict:
        """Each pool batch decoded once more: its decision words."""
        out = {}
        for j in range(self.P):
            self.program(self.pool[j])
            out[j] = self.program.words()
        return out

    def check(self, kept: dict, final: dict) -> tuple[dict, int, dict]:
        """As ``frames.Entry.check``, and each pool batch's words against
        the reference's decisions: one batch's reference at a time."""
        bytes_wrong = metrics_wrong = decisions_wrong = failed = data_errors = 0
        for j in sorted({n % self.P for n in kept} | set(final)):
            wb, wm, wd = decode(self.code, self.pool[j], self.nbytes)
            for n, (out, metrics, offset) in kept.items():
                if n % self.P != j:
                    continue
                got_m = metrics.to(torch.int64) + offset.to(torch.int64).reshape(-1, 1)
                eb, em = mismatch(out, wb), mismatch(got_m, wm)
                bytes_wrong, metrics_wrong = bytes_wrong + eb, metrics_wrong + em
                failed += bool(eb or em)
                data_errors += bit_errors(out, self.data[j])
            if j in final:
                ed = decision_mismatch(final[j], wd)
                decisions_wrong, failed = decisions_wrong + ed, failed + bool(ed)
            del wd
        T = 8 * self.nbytes + self.code.K - 1
        info = {"calls_compared": len(kept), "frames_compared": len(kept) * self.B,
                "ber_vs_data": data_errors / (len(kept) * self.B * 8 * self.nbytes),
                "decision_steps_compared": len(final) * self.B * T}
        return ({"bytes_wrong": bytes_wrong, "metrics_wrong": metrics_wrong,
                 "decisions_wrong": decisions_wrong}, failed, info)
