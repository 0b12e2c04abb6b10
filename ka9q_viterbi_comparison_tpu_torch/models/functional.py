"""Functional decode pipeline.

Port of ``ka9q_viterbi_comparison_tpu/models/functional.py``: reset + update
+ chainback as one function, for callers that do not time the phases apart.
PyTorch runs eagerly, so there is no compiled program; the default runs the
hand-written kernels on the card.
"""

from __future__ import annotations

import torch

from ..configs import CodeSpec, NumericSpec
from ..ops import acs, chainback as cb
from ..ops.cuda import dispatch
from .decoder import BACKENDS, as_symbols, resolve_device

__all__ = ["decode_fn", "decode_symbols"]


def decode_symbols(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    fused_penalties: bool | None = None,
    backend: str = "cuda",
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Decode tail-terminated frames ``[B, T*R]`` int32 -> bytes
    ``[B, num_data_bits // 8]`` uint8.

    ``fused_penalties`` applies to the ``"torch"`` backend; ``None`` picks
    the in-loop penalties (the whole-frame tensor is ``O(T*B*2S)``).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    B = symbols.shape[0]
    symbols = as_symbols(symbols, device).reshape(B, -1, code.R)
    metrics = acs.init_metrics(code, numeric, B, device=device)
    if backend == "cuda":
        _, words, _ = dispatch.acs_update(code, numeric, metrics, symbols)
        return dispatch.chainback(code, words, num_data_bits)
    fused = True if fused_penalties is None else fused_penalties
    _, words, _ = acs.acs_update(code, numeric, metrics, symbols, fused)
    return cb.chainback(code, words, num_data_bits)


def decode_fn(code: CodeSpec, numeric: NumericSpec, num_data_bits: int,
              backend: str = "cuda", device: torch.device | str = "cuda"):
    """Return a ``symbols [B, T*R] -> bytes`` closure over the static args."""

    def fn(symbols) -> torch.Tensor:
        return decode_symbols(code, numeric, symbols, num_data_bits, None, backend, device)

    return fn
