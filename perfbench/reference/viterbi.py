"""The plain reference decoder: soft-decision Viterbi in plain PyTorch.

It imports torch and numpy alone, and nothing of the program under test.
It is written from the rules the configuration states, which are libfec's:

* ``S = 2**(K-1)`` states; a state is the low K-1 bits of the encoder's
  register; input bit ``b`` moves state ``p`` to ``((p << 1) | b) & (S-1)``.
* The symbol of polynomial ``r`` on that transition is the parity of
  ``((p << 1) | b) & |poly_r|``, inverted where ``poly_r`` is negative.
* A received symbol ``y`` costs ``high - y`` against an expected 1 and
  ``y - low`` against an expected 0 (``soft_high``, ``soft_low``).
* Path metrics start at ``initial_margin`` for every state but the start
  state, which starts at 0; they are exact integers (held here in int64),
  never renormalised.
* New state ``s`` takes the better of its predecessors ``s >> 1`` (decision
  0) and ``(s >> 1) + S/2`` (decision 1); a tie keeps ``s >> 1``, ka9q's
  strict select.  ``ties_high`` reverses that rule (SPIRAL's ``min``): the
  benchmark's control.
* The traceback from state ``s`` at step ``t`` reads that step's decision
  ``k`` of ``s``, outputs ``k`` and moves to ``(s >> 1) | (k << (K-2))``.
  Output ``t`` is data bit ``t - (K-1)``; bytes are packed MSB first.

Decisions are kept as one bool a state and step on the device of the
symbols; the time loop is a Python loop of whole-batch tensor operations.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Code", "code_from_config", "pattern_penalties", "acs", "walk", "init_metrics",
           "decode_frames", "first_argmin", "bits_to_bytes", "StreamReference"]


@dataclasses.dataclass(frozen=True)
class Code:
    K: int
    polys: tuple[int, ...]
    soft_high: int
    soft_low: int
    initial_margin: int

    @property
    def R(self) -> int:
        return len(self.polys)

    @property
    def S(self) -> int:
        return 1 << (self.K - 1)


def code_from_config(cfg: dict) -> Code:
    """The code of a configuration file (``perfbench/configs/*.json``)."""
    return Code(int(cfg["K"]), tuple(int(p) for p in cfg["polys"]), int(cfg["soft_high"]),
                int(cfg["soft_low"]), int(cfg["initial_margin"]))


def _parity(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    for shift in (16, 8, 4, 2, 1):
        x ^= x >> shift
    return x & 1


def _tables(code: Code, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``pred [2S]`` and ``pattern [2S]``: for ``j = h*S + s``, the
    predecessor ``(s >> 1) + h*S/2`` of new state ``s`` and the index
    ``sum_r bit_r << r`` of the symbols its transition sends."""
    S = code.S
    s = torch.arange(S, dtype=torch.int64, device=device)
    pred = torch.cat([s >> 1, (s >> 1) + S // 2])
    reg = (pred << 1) | torch.cat([s & 1, s & 1])
    pattern = torch.zeros_like(reg)
    for r, p in enumerate(code.polys):
        bit = _parity(reg & abs(p)) ^ (1 if p < 0 else 0)
        pattern |= bit << r
    return pred, pattern


def pattern_penalties(code: Code, symbols: torch.Tensor) -> torch.Tensor:
    """``[..., T, R]`` symbols -> ``[..., T, 2**R]`` int64: the cost of each
    pattern of expected bits ``sum_r bit_r << r`` at each step."""
    y = symbols.to(torch.int64)
    P = 1 << code.R
    out = torch.zeros(*y.shape[:-1], P, dtype=torch.int64, device=y.device)
    bits = (torch.arange(P, device=y.device)[:, None] >> torch.arange(code.R, device=y.device)) & 1
    for r in range(code.R):
        yr = y[..., r, None]
        out += torch.where(bits[:, r].bool(), code.soft_high - yr, yr - code.soft_low)
    return out


def init_metrics(code: Code, batch: int, device, start_state: int = 0) -> torch.Tensor:
    m = torch.full((batch, code.S), code.initial_margin, dtype=torch.int64, device=device)
    m[:, start_state] = 0
    return m


def acs(code: Code, metrics: torch.Tensor, pen: torch.Tensor, dec: torch.Tensor,
        ties_high: bool = False) -> torch.Tensor:
    """Run the trellis over ``pen [T, B, 2**R]`` from ``metrics [B, S]``
    (int64), writing decisions ``dec [T, B, S]`` (bool); returns the
    metrics after the last step."""
    pred, pattern = _tables(code, metrics.device)
    S = code.S
    select = torch.le if ties_high else torch.lt
    for t in range(pen.shape[0]):
        cand = metrics.index_select(1, pred)
        cand += pen[t].index_select(1, pattern)
        lo, hi = cand[:, :S], cand[:, S:]
        d = select(hi, lo, out=dec[t])
        metrics = torch.where(d, hi, lo)
    return metrics


def first_argmin(metrics: torch.Tensor) -> torch.Tensor:
    """Each row's first state of least metric, ``[B]`` int64."""
    S = metrics.shape[-1]
    idx = torch.arange(S, device=metrics.device).expand_as(metrics)
    least = metrics.min(dim=-1, keepdim=True).values
    return torch.where(metrics == least, idx, S).min(dim=-1).values


def walk(code: Code, dec: torch.Tensor, ends: torch.Tensor, start: torch.Tensor,
         lo: int, hi: int) -> torch.Tensor:
    """Tracebacks through ``dec [T, B, S]``, walk ``j`` from state
    ``start[j]`` (``[n, B]``) at step ``ends[j] - 1`` down to step
    ``ends[j] - hi``; returns the outputs of steps ``ends[j] - hi`` to
    ``ends[j] - lo - 1`` as ``[n, B, hi - lo]`` uint8, oldest first."""
    n, B = start.shape
    b_idx = torch.arange(B, device=dec.device)[None, :]
    state = start.to(torch.int64).clone()
    out = torch.empty((n, B, hi - lo), dtype=torch.uint8, device=dec.device)
    for back in range(hi):
        t = (ends - 1 - back)[:, None]
        k = dec[t, b_idx, state]
        if back >= lo:
            out[:, :, hi - 1 - back] = k
        state = (state >> 1) | (k.to(torch.int64) << (code.K - 2))
    return out


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """``[..., 8N]`` 0/1 -> ``[..., N]`` uint8, MSB first."""
    w = 1 << torch.arange(7, -1, -1, device=bits.device, dtype=torch.int64)
    return (bits.reshape(*bits.shape[:-1], -1, 8).to(torch.int64) * w).sum(-1).to(torch.uint8)


def decode_frames(code: Code, symbols: torch.Tensor, data_bytes: int,
                  ties_high: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Tail-terminated frames ``[B, T*R]`` -> (bytes ``[B, data_bytes]``
    uint8, metrics after the last step ``[B, S]`` int64), walked from state
    0."""
    B = symbols.shape[0]
    T = 8 * data_bytes + code.K - 1
    pen = pattern_penalties(code, symbols.reshape(B, T, code.R)).transpose(0, 1).contiguous()
    dec = torch.empty((T, B, code.S), dtype=torch.bool, device=symbols.device)
    m = acs(code, init_metrics(code, B, symbols.device), pen, dec, ties_high)
    del pen
    ends = torch.tensor([T], device=symbols.device)
    zero = torch.zeros((1, B), dtype=torch.int64, device=symbols.device)
    bits = walk(code, dec, ends, zero, 0, 8 * data_bytes)[0]
    return bits_to_bytes(bits), m


class StreamReference:
    """A continuous stream that repeats a pool of ``P`` pushes of ``n``
    steps, decoded by the release rule of the program's documented stream:
    after push ``p`` (counted from the stream's start) the head is at step
    ``(p+1) n``; every step more than ``depth`` behind the head that was not
    released yet is released, walked from the first state of least metric
    at the head; the first K-1 outputs of the stream are never released.

    The reference runs pushes ``0 .. 2P`` and keeps every decision.  Because
    the symbols repeat with period ``P n``, the trellis from step ``P n`` on
    repeats too once the metrics at ``P n`` and ``2 P n`` differ by one
    constant a stream (``coupled``): then push ``p > 2P`` releases what push
    ``p'`` did, ``p' = P+1 + (p - P - 1) mod P``, and its metrics are push
    ``p'``'s plus ``(p - p') / P`` times that constant."""

    def __init__(self, code: Code, pool: torch.Tensor, n: int, depth: int,
                 ties_high: bool = False):
        B = pool.shape[0]
        P = pool.shape[1] // (n * code.R)
        self.code, self.n, self.depth, self.P, self.B = code, n, depth, P, B
        dev = pool.device
        pushes = 2 * P + 1
        self.dec = torch.empty((pushes * n, B, code.S), dtype=torch.bool, device=dev)
        m = init_metrics(code, B, dev)
        self.metrics = []
        for p in range(pushes):
            chunk = pool[:, (p % P) * n * code.R:(p % P + 1) * n * code.R]
            pen = pattern_penalties(code, chunk.reshape(B, n, code.R)).transpose(0, 1).contiguous()
            m = acs(code, m, pen, self.dec[p * n:(p + 1) * n], ties_high)
            self.metrics.append(m)
        delta = self.metrics[2 * P - 1] - self.metrics[P - 1]
        self.delta = delta[:, 0]
        self.coupled = bool((delta == delta[:, :1]).all())

    def _emitted(self, p: int) -> int:
        """Steps released before push ``p``."""
        return max(0, p * self.n - self.depth)

    def span(self, p: int) -> tuple[int, int]:
        """Absolute steps ``[a, b)`` whose outputs push ``p`` releases."""
        e = self._emitted(p)
        emit = max(0, (p + 1) * self.n - self.depth - e)
        skip = min(emit, max(0, (self.code.K - 1) - e))
        return e + skip, e + emit

    def mapped(self, p: int) -> tuple[int, int]:
        """``(p', cycles)``: the push computed here that push ``p``
        repeats, and how many periods later it comes."""
        top = 2 * self.P
        if p <= top:
            return p, 0
        if not self.coupled:
            raise ValueError("the reference's metrics did not repeat within two periods")
        q = self.P + 1 + (p - self.P - 1) % self.P
        return q, (p - q) // self.P

    def metrics_after(self, p: int) -> torch.Tensor:
        q, c = self.mapped(p)
        return self.metrics[q] + c * self.delta[:, None]

    def releases(self, pushes: list[int]) -> dict[int, torch.Tensor]:
        """The bits ``[B, m]`` uint8 that each push of ``pushes`` releases."""
        out = {}
        by_len: dict[tuple[int, int], list[int]] = {}
        for p in pushes:
            q, _ = self.mapped(p)
            a, b = self.span(q)
            by_len.setdefault((b - a, (q + 1) * self.n - a), []).append(q)
        for (m, hi), qs in by_len.items():
            qs = sorted(set(qs))
            if m == 0:
                for q in qs:
                    out[q] = torch.zeros((self.B, 0), dtype=torch.uint8, device=self.dec.device)
                continue
            ends = torch.tensor([(q + 1) * self.n for q in qs], device=self.dec.device)
            start = torch.stack([first_argmin(self.metrics[q]) for q in qs])
            bits = walk(self.code, self.dec, ends, start, hi - m, hi)
            for j, q in enumerate(qs):
                out[q] = bits[j]
        return {p: out[self.mapped(p)[0]] for p in pushes}
