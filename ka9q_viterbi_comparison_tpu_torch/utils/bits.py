"""Bit packing / unpacking and bit-error counting on torch tensors.

Port of ``ka9q_viterbi_comparison_tpu/utils/bits.py``.  Byte/bit order is
MSB-first, matching the order the reference encoder consumes input bytes and
its chainback emits decoded bytes
(ref: ka9q_libfec_port/viterbi27_sse2.cpp:97-103).

Packed 32-bit words are held as ``int32`` tensors carrying the uint32 bit
pattern (torch's ``uint32`` supports too few operations); compare them as
``.numpy().view(np.uint32)``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bytes_to_bits",
    "bits_to_bytes",
    "pack_bits_to_words",
    "unpack_words_to_bits",
    "wrap_int32",
    "count_bit_errors",
    "bit_error_rate",
]


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 ``[..., N]`` to bits ``[..., 8N]`` MSB-first, dtype uint8."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    bits = (data.to(torch.uint8)[..., :, None] >> shifts) & 1
    return bits.reshape(*data.shape[:-1], data.shape[-1] * 8)


def bits_to_bytes(bits: torch.Tensor) -> torch.Tensor:
    """Pack bits ``[..., 8N]`` (MSB-first) into uint8 ``[..., N]``."""
    n = bits.shape[-1]
    if n % 8 != 0:
        raise ValueError(f"bit count {n} not a multiple of 8")
    b = bits.reshape(*bits.shape[:-1], n // 8, 8).to(torch.int32)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 with the same bit pattern."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_bits_to_words(bits: torch.Tensor) -> torch.Tensor:
    """Pack bits ``[..., 32*W]`` into words ``[..., W]`` (int32 holding the
    uint32 pattern), bit ``i`` of a word holding bit ``32*w + i``.

    This is the decision-word layout: bit ``s % 32`` of word ``s // 32`` is the
    decision for trellis state ``s`` (ref: viterbi615_sse2.cpp:13, :86).
    """
    n = bits.shape[-1]
    if n % 32 != 0:
        raise ValueError(f"bit count {n} not a multiple of 32")
    b = bits.reshape(*bits.shape[:-1], n // 32, 32).to(torch.int64)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=bits.device)
    return wrap_int32((b * weights).sum(dim=-1))


def unpack_words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_bits_to_words``: int32 words ``[..., W]`` -> bits
    ``[..., 32*W]`` uint8."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32).to(torch.uint8)


def _np_u8(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.uint8)


def count_bit_errors(a, b) -> int:
    """Total differing bits between two equal-shaped uint8 arrays or tensors
    (ref: src/util.h:64-73)."""
    return int(np.unpackbits(np.bitwise_xor(_np_u8(a), _np_u8(b))).sum())


def bit_error_rate(a, b) -> float:
    total_bits = _np_u8(a).size * 8
    return count_bit_errors(a, b) / float(total_bits)
