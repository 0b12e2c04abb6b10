"""Batched convolutional encoder.

Port of ``ka9q_viterbi_comparison_tpu/ops/encoder.py``: the encoder is R
XOR-correlations over the whole bit stream instead of a clocked register
(ref: src/util.h:14-62).  Input bytes are consumed MSB-first, output symbol
order per trellis step is polynomial 0..R-1, K-1 zero tail bits terminate the
trellis at state 0, and bits map to ``soft_high`` / ``soft_low``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs import CodeSpec, NumericSpec
from ..utils.bits import bytes_to_bits

__all__ = ["encode_bits", "encode_frames", "encoded_symbol_count"]


def encoded_symbol_count(code: CodeSpec, data_bytes: int) -> int:
    return code.total_symbols(data_bytes)


def encode_bits(code: CodeSpec, data_bits: torch.Tensor) -> torch.Tensor:
    """Encode data bits ``[..., T_data]`` (0/1) into output bits
    ``[..., T, R]`` where ``T = T_data + K - 1`` includes the zero tail.

    Output bit ``[t, r] = parity(reg_t & poly[r]) ^ invert[r]``; register bit
    ``j`` at time ``t`` is ``b_{t-j}``.
    """
    K = code.K
    bits = F.pad(data_bits.to(torch.uint8), (0, K - 1))  # zero tail
    T = bits.shape[-1]
    padded = F.pad(bits, (K - 1, 0))  # zero history before t=0
    outs = []
    for p, inv in zip(code.abs_polys(), code.inversions()):
        acc = torch.zeros_like(bits)
        for j in range(K):
            if (p >> j) & 1:
                acc ^= padded[..., K - 1 - j : K - 1 - j + T]
        if inv:
            acc ^= 1
        outs.append(acc)
    return torch.stack(outs, dim=-1)  # [..., T, R]


def encode_frames(
    code: CodeSpec, numeric: NumericSpec, data_bytes: torch.Tensor
) -> torch.Tensor:
    """Encode uint8 frames ``[..., N]`` into soft symbols ``[..., T*R]`` int32,
    bits mapped to the numeric spec's rail values (ref: src/util.h:14-62)."""
    enc = encode_bits(code, bytes_to_bits(data_bytes))  # [..., T, R]
    syms = torch.where(enc.bool(), numeric.soft_high, numeric.soft_low).to(torch.int32)
    return syms.reshape(*syms.shape[:-2], syms.shape[-2] * syms.shape[-1])
