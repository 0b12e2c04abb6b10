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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec
from ..ops import acs, chainback as cb
from ..ops.cuda import dispatch

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
        self.metrics = acs.init_metrics(self.code, self.numeric, self.batch, starting_state,
                                        self.device)
        self.renorm_offset = torch.zeros((self.batch,), dtype=torch.int32, device=self.device)
        self._decision_blocks: list[torch.Tensor] = []
        self._steps = 0  # trellis steps consumed (blockwise resume cursor)

    # -- phase 2: symbol update (ref: update_viterbi27_blk_sse2) --
    def update(self, symbols) -> None:
        """Consume ``[B, n*R]`` (or ``[B, n, R]``) soft symbols; resumable in
        blocks like the reference's update (viterbi27_sse2.cpp:119)."""
        symbols = as_symbols(symbols, self.device).reshape(self.batch, -1, self.code.R)
        if self.backend == "cuda":
            # t0 keeps the in-place kernel's rotation phases (and decision
            # packing positions) globally consistent across blocks.
            self.metrics, words, off = dispatch.acs_update(
                self.code, self.numeric, self.metrics, symbols, self._steps)
        else:
            self.metrics, words, off = acs.acs_update(
                self.code, self.numeric, self.metrics, symbols, fused_penalties=True)
        self.renorm_offset = self.renorm_offset + off
        self._decision_blocks.append(words)
        self._steps += symbols.shape[1]

    # -- phase 3: chainback (ref: chainback_viterbi27_sse2) --
    def chainback(self, num_data_bits: int, endstate: int = 0) -> torch.Tensor:
        """Decode ``[B, num_data_bits // 8]`` uint8 from the accumulated
        decision history."""
        words = (self._decision_blocks[0] if len(self._decision_blocks) == 1
                 else torch.cat(self._decision_blocks, dim=1))
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
