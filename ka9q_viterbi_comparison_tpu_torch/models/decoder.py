"""User-facing decoder models.

Port of ``ka9q_viterbi_comparison_tpu/models/decoder.py``.  ``ViterbiDecoder``
reproduces the reference's three-phase lifecycle -- ``reset() ->
update(symbols) -> chainback(bits)`` (ref: src/ka9q_interface.h:45-55,
src/main.cpp:175-189) -- as a thin stateful shell over the ops.

Backends:

* ``"cuda"``  -- the hand-written kernels through ``ops.cuda.dispatch`` (on a
                 CPU device, their plain versions).
* ``"torch"`` -- the portable tensor path (``ops.acs`` / ``ops.chainback``).

``device`` defaults to ``"cuda"``: the decoder runs on the card unless the
caller asks for the CPU.

On the routes of the whole-frame kernels (``dispatch.whole_frame``) the
decoder keeps its words in the kernels' layout: one buffer ``[Tcap, W, B]``
into whose rows each update's kernel writes (``out=``), grown by doubling,
which the traceback walks where it lies.  An update there is the kernel
reading the caller's batch-major symbols and the metrics where they lie
(and on the in-place route at most a gather of the ``[B, S]`` metrics at
each block edge off rotation phase 0); its offset is zero, so nothing is
added to ``renorm_offset``.

Under a profiler the phases are the spans ``ka9q.reset``, ``ka9q.update``
and ``ka9q.chainback``, and the word buffer's growth ``ka9q.alloc``
(``utils.spans``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec
from ..ops import acs, chainback as cb
from ..ops.cuda import dispatch
from ..utils.spans import span

__all__ = ["ViterbiDecoder", "decode_frames", "resolve_device"]

BACKENDS = ("cuda", "torch")


def resolve_device(device: torch.device | str) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device on a machine without
    one (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU")
    return device


def as_symbols(symbols, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> int32 tensor on ``device``."""
    if isinstance(symbols, np.ndarray):
        symbols = torch.from_numpy(symbols)
    return symbols.to(device=device, dtype=torch.int32)


@dataclasses.dataclass
class ViterbiDecoder:
    """Batched stateful Viterbi decoder with the reference's 3-phase contract.

    Example::

        dec = ViterbiDecoder(VITERBI27, soft8_spec(2), batch=64)
        dec.reset()
        dec.update(symbols)             # [64, T*R] int32, may be called in blocks
        data = dec.chainback(8192)      # [64, 1024] uint8
    """

    code: CodeSpec
    numeric: NumericSpec
    batch: int
    backend: str = "cuda"
    device: torch.device | str = "cuda"

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")
        self.device = resolve_device(self.device)
        self.reset()

    # -- phase 1: reset (ref: init_viterbi27_sse2, viterbi27_sse2.cpp:42-53) --
    def reset(self, starting_state: int = 0) -> None:
        with span("ka9q.reset"):
            self.metrics = acs.init_metrics(self.code, self.numeric, self.batch, starting_state,
                                            self.device)
            self.renorm_offset = torch.zeros((self.batch,), dtype=torch.int32,
                                             device=self.device)
            self._buf: torch.Tensor | None = None  # the whole-frame routes' words [Tcap, W, B]
            # Each update's words: a [B, t, W] tensor, or its row range (lo, hi) of _buf.
            self._blocks: list = []
            self._steps = 0  # trellis steps consumed (blockwise resume cursor)

    def _whole_frame(self) -> bool:
        return self.backend == "cuda" and dispatch.whole_frame(self.code, self.batch, self.device)

    def _rows(self, lo: int, n: int) -> torch.Tensor:
        """Rows ``[lo, lo + n)`` of the word buffer, which grows by doubling
        (its first ``lo`` rows copied over) when it has fewer."""
        hi = lo + n
        if self._buf is None or self._buf.shape[0] < hi:
            with span("ka9q.alloc"):
                cap = hi if self._buf is None else max(hi, 2 * self._buf.shape[0])
                buf = torch.empty((cap, self.code.decision_words, self.batch),
                                  dtype=torch.int32, device=self.device)
                if self._buf is not None and lo:
                    buf[:lo] = self._buf[:lo]
                self._buf = buf
        return self._buf[lo:hi]

    @property
    def _decision_blocks(self) -> list[torch.Tensor]:
        """Each update's decision words ``[B, t, W]`` (views of the word
        buffer on the whole-frame routes)."""
        return [b if isinstance(b, torch.Tensor) else self._buf[b[0]:b[1]].permute(2, 0, 1)
                for b in self._blocks]

    @_decision_blocks.setter
    def _decision_blocks(self, blocks: list[torch.Tensor]) -> None:
        """Load decision words ``[B, t, W]`` a block (a resumed decoder's
        history): into the word buffer on the whole-frame routes."""
        self._buf, self._blocks, lo = None, [], 0
        for words in blocks:
            n = words.shape[1]
            if self._whole_frame():
                self._rows(lo, n).copy_(words.permute(1, 2, 0))
                self._blocks.append((lo, lo + n))
            else:
                self._blocks.append(words)
            lo += n

    # -- phase 2: symbol update (ref: update_viterbi27_blk_sse2) --
    def update(self, symbols) -> None:
        """Consume ``[B, n*R]`` (or ``[B, n, R]``) soft symbols; resumable in
        blocks like the reference's update (viterbi27_sse2.cpp:119)."""
        with span("ka9q.update"):
            symbols = as_symbols(symbols, self.device).reshape(self.batch, -1, self.code.R)
            lo, n = self._steps, symbols.shape[1]
            if self._whole_frame():
                # t0 keeps the in-place kernel's rotation phases (and decision
                # packing positions) globally consistent across blocks.  The
                # offset is zero here.
                self.metrics, _, _ = dispatch.acs_update(self.code, self.numeric, self.metrics,
                                                         symbols, lo, self._rows(lo, n))
                self._blocks.append((lo, lo + n))
            else:
                if self.backend == "cuda":
                    self.metrics, words, off = dispatch.acs_update(
                        self.code, self.numeric, self.metrics, symbols, lo)
                else:
                    self.metrics, words, off = acs.acs_update(
                        self.code, self.numeric, self.metrics, symbols, fused_penalties=True)
                self.renorm_offset = self.renorm_offset + off
                self._blocks.append(words)
            self._steps = lo + n

    # -- phase 3: chainback (ref: chainback_viterbi27_sse2) --
    def chainback(self, num_data_bits: int, endstate: int = 0) -> torch.Tensor:
        """Decode ``[B, num_data_bits // 8]`` uint8 from the accumulated
        decision history."""
        with span("ka9q.chainback"):
            if self._blocks and all(isinstance(b, tuple) for b in self._blocks):
                words = self._buf[:self._steps].permute(2, 0, 1)  # walked where it lies
            else:
                blocks = self._decision_blocks
                words = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
            if self.backend == "cuda":
                return dispatch.chainback(self.code, words, num_data_bits, endstate)
            return cb.chainback(self.code, words, num_data_bits, endstate)

    def path_metric(self, endstate: int = 0) -> torch.Tensor:
        """Accumulated path error of the survivor at ``endstate`` per frame,
        including everything removed by renormalisation
        (ref: viterbi615_sse2.cpp:76, :175)."""
        return self.metrics[:, endstate & (self.code.num_states - 1)] + self.renorm_offset


def decode_frames(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    backend: str = "cuda",
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """One-shot decode of tail-terminated frames.

    ``symbols``: ``[B, T*R]`` int32 -> decoded bytes ``[B, num_data_bits//8]``.
    """
    dec = ViterbiDecoder(code, numeric, batch=symbols.shape[0], backend=backend, device=device)
    dec.update(symbols)
    return dec.chainback(num_data_bits)
