"""Streaming (continuous) decoding with bounded latency and checkpoint/resume.

Port of ``ka9q_viterbi_comparison_tpu/models/streaming.py``.  The reference's
decoders are resumable in blocks -- ``update`` can be called repeatedly and
the complete decoder state is (path metrics, decision history) (ref:
viterbi27_sse2.cpp:119-174; SURVEY §5 "checkpoint/resume") -- and this module
decodes an unbounded symbol stream with a sliding decision window, releasing
bits with a fixed latency by truncated traceback (survivor paths merge within
some 5-8 K steps).

Backends, those of ``ViterbiDecoder``:

* ``"cuda"``  -- the update through ``ops.cuda.dispatch.acs_update`` with
  ``t0`` = the stream's absolute step, so the in-place kernel's rotation
  phases stay consistent across pushes; the release walk through the
  traceback kernels: ``chainback_inplace`` with the window's ``t0`` over
  position-packed history, ``chainback_tb`` over state-order history
  (any K up to 24).  On a CPU device the kernels' plain versions run.
* ``"torch"`` -- the portable path (``ops.acs`` and ``ops.chainback``).

Whether the history is position-packed is decided once, at construction, by
the in-place route's predicate (``dispatch.use_inplace`` on the batch), and a
stream walks by that decision whatever the environment says later.  The
history lives in the kernels' ``[T, W, B]`` layout; ``checkpoint`` gives it
batch-major, ``[B, h, W]``, as the JAX package's checkpoint does, and
``restore`` takes it back.  A push runs eagerly: a handful of kernel
launches and tensor operations, with no per-shape program to build.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs import CodeSpec, NumericSpec
from ..ops import acs, chainback as cb
from ..ops.cuda import dispatch, inplace, kernels
from .decoder import BACKENDS, as_symbols, resolve_device

__all__ = ["StreamingDecoder"]


@dataclasses.dataclass
class StreamingDecoder:
    """Continuous batched Viterbi decoder.

    ``push(symbols)`` consumes ``[B, n*R]`` soft symbols and returns the data
    bits (``[B, m]`` uint8, possibly m=0) that became decodable: everything
    older than ``traceback_depth`` trellis steps behind the stream head.
    ``flush(endstate)`` drains the tail (e.g. at the end of a tail-terminated
    stream, endstate=0).
    """

    code: CodeSpec
    numeric: NumericSpec
    batch: int
    traceback_depth: int = 0  # 0 -> 8*K
    backend: str = "cuda"
    device: torch.device | str = "cuda"

    def __post_init__(self) -> None:
        if self.traceback_depth <= 0:
            self.traceback_depth = 8 * self.code.K
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        self.device = resolve_device(self.device)
        self._rotated = self.backend == "cuda" and dispatch.use_inplace(
            self.code, self.batch, self.device)
        self.reset()

    def reset(self, starting_state: int = 0) -> None:
        self.metrics = acs.init_metrics(self.code, self.numeric, self.batch, starting_state,
                                        self.device)
        self._hist = torch.zeros((0, self.code.decision_words, self.batch), dtype=torch.int32,
                                 device=self.device)  # [h, W, B]
        self.steps_emitted = 0  # trellis steps already released as bits
        self.abs_step = 0       # stream head (total steps consumed)

    @property
    def history(self) -> torch.Tensor:
        """The retained decision words ``[B, h, W]`` int32 (a view)."""
        return self._hist.permute(2, 0, 1)

    # -- state as plain tensors (checkpoint/resume) --
    def checkpoint(self) -> dict[str, Any]:
        return {
            "metrics": self.metrics.clone(),
            "history": self.history.contiguous(),
            "steps_emitted": self.steps_emitted,
            "abs_step": self.abs_step,
            # The in-place route position-packs words (rotr(s, (t+1) mod
            # (K-1))); a restore onto a decoder whose route packs differently
            # would mis-decode the restored window, so it is refused.
            "rotated_history": self._rotated,
        }

    def restore(self, state: dict[str, Any]) -> None:
        """Continue from ``checkpoint()``'s dict (tensors on any device; a JAX
        checkpoint through ``convert.streaming_checkpoint_from_jax``)."""
        rot = bool(state.get("rotated_history", False))
        if rot != self._rotated:
            raise ValueError(
                "checkpoint decision-history packing "
                f"({'position' if rot else 'state'}-ordered) does not match "
                "this decoder's route; restore on a decoder with the same "
                "backend routing (same backend/batch/device/KA9Q_TORCH_INPLACE)")
        B, S, W = self.batch, self.code.num_states, self.code.decision_words
        metrics = state["metrics"].to(device=self.device, dtype=torch.int32)
        history = state["history"].to(device=self.device, dtype=torch.int32)
        steps_emitted, abs_step = int(state["steps_emitted"]), int(state["abs_step"])
        if tuple(metrics.shape) != (B, S) or history.ndim != 3 \
                or tuple(history.shape) != (B, abs_step - steps_emitted, W):
            raise ValueError(f"checkpoint metrics {tuple(metrics.shape)} / history "
                             f"{tuple(history.shape)} do not fit batch {B}, {S} states, "
                             f"{abs_step - steps_emitted} retained steps")
        self.metrics = metrics.clone()
        self._hist = history.permute(1, 2, 0).contiguous()
        self.steps_emitted, self.abs_step = steps_emitted, abs_step

    def push(self, symbols) -> torch.Tensor:
        """Consume symbols, return newly released data bits ``[B, m]`` uint8."""
        symbols = as_symbols(symbols, self.device).reshape(self.batch, -1, self.code.R)
        n = symbols.shape[1]
        if n == 0:
            return torch.zeros((self.batch, 0), dtype=torch.uint8, device=self.device)
        emit = max(0, (self.abs_step + n - self.traceback_depth) - self.steps_emitted)
        skip = min(emit, max(0, (self.code.K - 1) - self.steps_emitted)) if emit else 0
        if self.backend == "cuda":
            self.metrics, words, _ = dispatch.acs_update(
                self.code, self.numeric, self.metrics, symbols, self.abs_step)
        else:
            self.metrics, words, _ = acs.acs_update(
                self.code, self.numeric, self.metrics, symbols, fused_penalties=True)
        # The window, padded for the traceback kernels in the same copy.
        h, Tw = self._hist.shape[0], self._hist.shape[0] + n
        buf = self._window(Tw)
        buf[:h] = self._hist
        buf[h:Tw] = words.permute(1, 2, 0)  # the kernels' own [n, W, B]: no copy before this one
        self.abs_step += n
        if emit <= 0:
            self._hist = buf[:Tw]
            return torch.zeros((self.batch, 0), dtype=torch.uint8, device=self.device)
        raw = self._walk(buf, Tw, self.metrics.argmin(dim=-1).to(torch.int32))
        self._hist = buf[emit:Tw]
        self.steps_emitted += emit
        return raw[:, skip:emit]

    def flush(self, endstate: int | None = 0) -> torch.Tensor:
        """Release every remaining step (stream over; default: trellis was
        tail-terminated at state 0; ``None``: from the best state)."""
        return self._release(self.abs_step - self.steps_emitted, endstate)

    def _release(self, n_steps: int, endstate) -> torch.Tensor:
        B = self.batch
        if n_steps <= 0:
            return torch.zeros((B, 0), dtype=torch.uint8, device=self.device)
        # Traceback over the whole retained history from the best (or given)
        # end state; only the oldest n_steps outputs are final.
        if endstate is None:
            end = self.metrics.argmin(dim=-1).to(torch.int32)
        else:
            end = torch.full((B,), endstate & (self.code.num_states - 1), dtype=torch.int32,
                             device=self.device)
        Tw = self._hist.shape[0]
        buf = self._window(Tw)
        buf[:Tw] = self._hist
        out = self._walk(buf, Tw, end)[:, :n_steps]
        self._hist = self._hist[n_steps:]
        self.steps_emitted += n_steps
        # Walk output at absolute step t is data bit t - (K-1): the first
        # K-1 outputs of the stream are the encoder's warm-up, dropped here.
        skip = max(0, (self.code.K - 1) - (self.steps_emitted - n_steps))
        return out[:, skip:]

    def _window(self, Tw: int) -> torch.Tensor:
        """An ``[Tp, W, B]`` buffer for a window of ``Tw`` steps, its time
        padded to whole traceback words and the padding zeroed."""
        Tp = inplace.pad_time_inplace(self.code, Tw)
        buf = torch.empty((Tp, self.code.decision_words, self.batch), dtype=torch.int32,
                          device=self.device)
        buf[Tw:] = 0
        return buf

    def _walk(self, buf: torch.Tensor, Tw: int, end: torch.Tensor) -> torch.Tensor:
        """Walk outputs ``[B, Tw]`` uint8 of the window ``buf[:Tw]``, whose
        first step is the absolute step ``steps_emitted``."""
        if self.backend == "cuda":
            if self._rotated:
                return dispatch.walk_bits(self.code, inplace.chainback_inplace, buf, Tw, end,
                                          self.steps_emitted)
            return dispatch.walk_bits(self.code, kernels.chainback_tb, buf, Tw, end)
        return _raw_walk(self.code, buf[:Tw].permute(2, 0, 1), end, self._rotated,
                         self.steps_emitted)


def _raw_walk(code: CodeSpec, words: torch.Tensor, end: torch.Tensor, rotated: bool = False,
              t_offset: int = 0) -> torch.Tensor:
    """Plain reverse decision walk over ``[B, n, W]`` from ``end``: the full
    output sequence ``[B, n]`` uint8.  ``rotated``: position-packed words
    (``ops.chainback.walk``); ``t_offset``: the absolute step of
    ``words[:, 0]``."""
    ks, _ = cb.walk(code, words, end, rotated, t_offset)
    return ks.to(torch.uint8)
