"""The benchmark's own encoder and AWGN channel (a frozen copy of the
program's ``ops/encoder.py`` and ``ops/channel.py``, so that a change to the
program cannot change the yardstick).

Bits enter the encoder MSB first; output bit ``[t, r]`` is the parity of
the register ``sum_j b_{t-j} << j`` masked by ``|poly_r|``, inverted where
``poly_r`` is negative; the register starts at zero.  A bit maps to
``+/- A`` around the mid-rail, ``A = (high - low) / 2``; Gaussian noise of
``sigma = sqrt(1 / (2 Es/N0))`` with ``Es/N0 = Eb/N0 / R`` is added in
units of ``A``, and the result is rounded half to even and clipped to the
rails.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .viterbi import Code

__all__ = ["bytes_to_bits", "encode_bits", "ebn0_sigma", "awgn"]


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., N]`` -> bits ``[..., 8N]`` uint8, MSB first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data.device)
    return ((data.to(torch.uint8)[..., :, None] >> shifts) & 1).reshape(*data.shape[:-1], -1)


def encode_bits(code: Code, bits: torch.Tensor, tail: bool = True) -> torch.Tensor:
    """Data bits ``[..., n]`` -> code bits ``[..., T, R]``: ``T = n + K - 1``
    with K-1 zero tail bits (``tail``), else ``T = n``."""
    K = code.K
    bits = bits.to(torch.uint8)
    if tail:
        bits = F.pad(bits, (0, K - 1))
    T = bits.shape[-1]
    padded = F.pad(bits, (K - 1, 0))  # zero register before t = 0
    outs = []
    for p in code.polys:
        acc = torch.zeros_like(bits)
        for j in range(K):
            if (abs(p) >> j) & 1:
                acc ^= padded[..., K - 1 - j:K - 1 - j + T]
        if p < 0:
            acc ^= 1
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def ebn0_sigma(code: Code, ebn0_db: float) -> float:
    es_n0 = (10.0 ** (ebn0_db / 10.0)) / code.R
    return float((1.0 / (2.0 * es_n0)) ** 0.5)


def awgn(code: Code, coded: torch.Tensor, ebn0_db: float,
         generator: torch.Generator) -> torch.Tensor:
    """Code bits ``[B, T, R]`` -> soft symbols ``[B, T*R]`` int32."""
    high, low = code.soft_high, code.soft_low
    mid, amp = (high + low) / 2.0, (high - low) / 2.0
    clean = torch.where(coded.bool(), 1.0, -1.0).to(torch.float32)
    noise = torch.randn(clean.shape, generator=generator, device=coded.device,
                        dtype=torch.float32)
    rx = mid + amp * (clean + ebn0_sigma(code, ebn0_db) * noise)
    return torch.clamp(torch.round(rx), low, high).to(torch.int32).reshape(coded.shape[0], -1)
