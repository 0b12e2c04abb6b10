"""Streaming (continuous) decoding with bounded latency and checkpoint/resume.

Port of ``ka9q_viterbi_comparison_tpu/models/streaming.py``.  The reference's
decoders are resumable in blocks -- ``update`` can be called repeatedly and
the complete decoder state is (path metrics, decision history) (ref:
viterbi27_sse2.cpp:119-174; SURVEY §5 "checkpoint/resume") -- and this module
decodes an unbounded symbol stream with a sliding decision window, releasing
bits with a fixed latency by truncated traceback (survivor paths merge within
some 5-8 K steps).

Backends, those of ``ViterbiDecoder``:

* ``"cuda"``  -- the update with ``t0`` = the stream's absolute step, so the
  in-place kernel's rotation phases stay consistent across pushes; the
  release walk through the traceback kernels: ``chainback_inplace`` with the
  window's ``t0`` over position-packed history, ``chainback_tb`` over
  state-order history (any K up to 24).  On a CPU device the kernels' plain
  versions run.
* ``"torch"`` -- the portable path (``ops.acs`` and ``ops.chainback``).

The window.  The history lives in one buffer ``[Tcap, W, B]`` in the
kernels' layout, allocated at the first push with room for the traceback
depth and the push padded to whole traceback words, and grown only when a
larger push comes.  On the routes of the whole-frame kernels (the in-place
pair, and the state-order pair for K <= 9) a push is three launches, the
counterpart of the one program the JAX stream compiles for each shape: the
update, which reads the pushed batch-major symbols where they lie and writes
its decisions straight into rows ``[h, h + n)`` of the window (``out=``);
the walk, which takes the end state as the argmin of the metrics itself and
writes the released bits straight into the returned ``[B, m]`` tensor (its
``bits`` form); and one copy of the retained rows to the front of the
window.  The metrics stay in the kernels' ``[S, B]`` (position space of the
stream head's phase on the in-place route); ``metrics`` and ``checkpoint``
give them batch-major in state order, ``[B, S]``, as the JAX package does.  The large-K route updates through
``dispatch.acs_update`` and copies its words into the window.

Whether the history is position-packed is decided once, at construction, by
the in-place route's predicate (``dispatch.use_inplace`` on the batch), and a
stream walks by that decision whatever the environment says later.
``checkpoint`` gives the history batch-major, ``[B, h, W]``, as the JAX
package's checkpoint does, and ``restore`` refills the window from it.

Under a profiler a push is the span ``ka9q.push``, with its walk
(``ka9q.push.walk``) and its copy of the retained rows (``ka9q.push.retain``)
inside it; the window's growth is ``ka9q.alloc`` (``utils.spans``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs import CodeSpec, NumericSpec
from ..ops import acs, chainback as cb
from ..ops.cuda import dispatch, inplace, kernels
from ..utils.spans import span
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
        # The whole-frame kernels' routes keep the metrics [S, B]; the others [B, S].
        self._native = self._rotated or (self.backend == "cuda" and dispatch.supports(self.code))
        self._buf: torch.Tensor | None = None  # the window [Tcap, W, B]
        self.reset()

    def reset(self, starting_state: int = 0) -> None:
        self.steps_emitted = 0  # trellis steps already released as bits
        self.abs_step = 0       # stream head (total steps consumed)
        self._len = 0           # steps in the window
        self.metrics = acs.init_metrics(self.code, self.numeric, self.batch, starting_state,
                                        self.device)

    def _phase(self) -> int:
        """The rotation phase of the metrics' position space (0: state order)."""
        return self.abs_step % (self.code.K - 1) if self._rotated else 0

    @property
    def metrics(self) -> torch.Tensor:
        """The path metrics ``[B, S]`` int32 in state order."""
        if not self._native:
            return self._m
        m = self._m
        if self._phase():
            m = m[dispatch._rot_index(self.code, self._phase(), True, self.device)]
        return m.T.contiguous()

    @metrics.setter
    def metrics(self, value: torch.Tensor) -> None:
        m = value.to(device=self.device, dtype=torch.int32)
        if self._native:
            m = m.T
            if self._phase():
                m = m[dispatch._rot_index(self.code, self._phase(), False, self.device)]
        self._m = m.contiguous()

    @property
    def history(self) -> torch.Tensor:
        """The retained decision words ``[B, h, W]`` int32 (a view)."""
        if self._buf is None:
            return torch.zeros((self.batch, 0, self.code.decision_words), dtype=torch.int32,
                               device=self.device)
        return self._buf[:self._len].permute(2, 0, 1)

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
        self.steps_emitted, self.abs_step = steps_emitted, abs_step
        self.metrics = metrics  # after abs_step: the in-place route rotates them to its phase
        h = history.shape[1]
        self._len = 0
        self._window(h)[:h].copy_(history.permute(1, 2, 0))
        self._len = h

    def push(self, symbols) -> torch.Tensor:
        """Consume symbols, return newly released data bits ``[B, m]`` uint8."""
        with span("ka9q.push"):
            symbols = as_symbols(symbols, self.device).reshape(self.batch, -1, self.code.R)
            n = symbols.shape[1]
            if n == 0:
                return torch.zeros((self.batch, 0), dtype=torch.uint8, device=self.device)
            emit = max(0, (self.abs_step + n - self.traceback_depth) - self.steps_emitted)
            skip = min(emit, max(0, (self.code.K - 1) - self.steps_emitted)) if emit else 0
            h, Tw = self._len, self._len + n
            rows = self._window(Tw)[h:Tw]  # where this push's decisions go
            if self._native:
                sym = symbols.permute(1, 2, 0)  # the kernels' [n, R, B], a view
                if self._rotated:
                    self._m, _ = inplace.acs_update_inplace(self.code, self.numeric, self._m, sym,
                                                            n, self.abs_step, out=rows)
                else:
                    self._m, _ = dispatch._small_k_impl(self.batch)(self.code, self.numeric,
                                                                    self._m, sym, n, out=rows)
            else:
                if self.backend == "cuda":
                    self._m, words, _ = dispatch.acs_update(self.code, self.numeric, self._m,
                                                            symbols, self.abs_step)
                else:
                    self._m, words, _ = acs.acs_update(self.code, self.numeric, self._m, symbols,
                                                       fused_penalties=True)
                rows.copy_(words.permute(1, 2, 0))
            self.abs_step += n
            self._len = Tw
            if emit <= 0:
                return torch.zeros((self.batch, 0), dtype=torch.uint8, device=self.device)
            return self._release_steps(emit, skip, None)

    def flush(self, endstate: int | None = 0) -> torch.Tensor:
        """Release every remaining step (stream over; default: trellis was
        tail-terminated at state 0; ``None``: from the best state)."""
        return self._release(self.abs_step - self.steps_emitted, endstate)

    def _release(self, n_steps: int, endstate) -> torch.Tensor:
        if n_steps <= 0:
            return torch.zeros((self.batch, 0), dtype=torch.uint8, device=self.device)
        # Walk output at absolute step t is data bit t - (K-1): the first K-1
        # outputs of the stream are the encoder's warm-up, dropped here.
        skip = min(n_steps, max(0, (self.code.K - 1) - self.steps_emitted))
        return self._release_steps(n_steps, skip, endstate)

    def _release_steps(self, emit: int, skip: int, endstate) -> torch.Tensor:
        """Walk the window from the best (``endstate`` None) or the given end
        state, release the outputs of its steps ``[skip, emit)`` -- only the
        oldest ``emit`` are final -- and drop its first ``emit`` steps."""
        Tw, B = self._len, self.batch
        out = torch.empty((B, emit - skip), dtype=torch.uint8, device=self.device)
        if emit > skip:
            with span("ka9q.push.walk"):
                self._walk(Tw, endstate, skip, emit, out)
        keep = Tw - emit
        if keep:
            with span("ka9q.push.retain"):
                src = self._buf[emit:Tw]
                # Source and destination overlap when the window keeps more than it drops.
                self._buf[:keep].copy_(src if emit >= keep else src.clone())
        self._len = keep
        self.steps_emitted += emit
        return out

    def _window(self, Tw: int) -> torch.Tensor:
        """The window buffer, with room for ``Tw`` steps: grown (its ``_len``
        retained steps copied over) only when it has less."""
        if self._buf is None or self._buf.shape[0] < Tw:
            with span("ka9q.alloc"):
                cap = inplace.pad_time_inplace(self.code,
                                               max(Tw, self.traceback_depth + Tw - self._len))
                buf = torch.empty((cap, self.code.decision_words, self.batch),
                                  dtype=torch.int32, device=self.device)
                if self._len:
                    buf[:self._len] = self._buf[:self._len]
                self._buf = buf
        return self._buf

    def _walk(self, Tw: int, endstate, lo: int, hi: int, out: torch.Tensor) -> None:
        """Walk outputs of steps ``[lo, hi)`` of the window's ``Tw`` steps,
        whose first is the absolute step ``steps_emitted``, into ``out``: from
        ``endstate``, or (None) from each frame's first state of least
        metric."""
        code, buf = self.code, self._buf
        if self.backend == "cuda":
            # [S, B] views of the metrics: the walk takes their argmin itself.
            m = None if endstate is not None else (self._m if self._native else self._m.T)
            if self._rotated:
                inplace.chainback_inplace(code, buf, endstate, Tw, self.steps_emitted, "bits",
                                          lo, hi, out=out, metrics=m, metrics_phase=self._phase())
            else:
                kernels.chainback_tb(code, buf, endstate, Tw, "bits", lo, hi, out=out, metrics=m)
            return
        end = self._m.argmin(dim=-1).to(torch.int32) if endstate is None else endstate
        ks, _ = cb.walk(code, buf[:Tw].permute(2, 0, 1), end)  # the portable walk
        out.copy_(ks[:, lo:hi])
