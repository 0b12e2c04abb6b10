"""AWGN channel over the rail mapping.

Port of ``ka9q_viterbi_comparison_tpu/ops/channel.py``.  The reference has
soft-decision machinery but never injects noise (SURVEY §4; ref:
src/util.h:36, src/main.cpp:110-115); this module gives the noisy half:
encode, add Gaussian noise at an Eb/N0, quantise back to the soft alphabet.

Conventions (the JAX package's): a transmitted bit maps to ``+/- A`` with
``A = (high - low) / 2`` around the mid-rail; noise sigma follows from Eb/N0
with rate compensation ``Es/N0 = Eb/N0 * (1/R)``; received values are rounded
half to even (``torch.round``, as ``jnp.round``) and clipped to the rails.

The noise comes from a ``torch.Generator`` on the device: the same seed gives
the same symbols on the same device, but not the JAX package's symbols
(``jax.random`` streams are not reproducible in PyTorch).
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import resolve_device
from ..utils.bits import bytes_to_bits
from .encoder import encode_bits

__all__ = ["awgn_symbols", "ebn0_sigma", "awgn_encode_frames"]


def ebn0_sigma(code: CodeSpec, ebn0_db: float) -> float:
    """Noise sigma for unit-amplitude antipodal symbols at a given Eb/N0 (dB):
    ``Es/N0 = Eb/N0 * (1/R)``, ``sigma^2 = 1 / (2 * Es/N0)``."""
    es_n0 = (10.0 ** (ebn0_db / 10.0)) / code.R
    return float((1.0 / (2.0 * es_n0)) ** 0.5)


def awgn_symbols(
    code: CodeSpec,
    numeric: NumericSpec,
    data_bytes,
    ebn0_db: float,
    generator: torch.Generator | None = None,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Encode ``[B, N]`` uint8 frames (numpy or tensor) and pass them through
    an AWGN channel on ``device``.

    ``generator``: a ``torch.Generator`` on ``device`` (``None``: the
    device's default generator).  Returns integer soft symbols ``[B, T*R]``
    int32 in the numeric spec's rail range."""
    device = resolve_device(device)
    if generator is not None and torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device}, symbols asked on {device}")
    if isinstance(data_bytes, np.ndarray):
        data_bytes = torch.from_numpy(data_bytes)
    enc = encode_bits(code, bytes_to_bits(data_bytes.to(device=device, dtype=torch.uint8)))
    B = enc.shape[0]
    high, low = numeric.soft_high, numeric.soft_low
    mid, amp = (high + low) / 2.0, (high - low) / 2.0
    clean = torch.where(enc.bool(), 1.0, -1.0).to(torch.float32)
    noise = torch.randn(clean.shape, generator=generator, device=device, dtype=torch.float32)
    rx = mid + amp * (clean + ebn0_sigma(code, ebn0_db) * noise)
    return torch.clamp(torch.round(rx), low, high).to(torch.int32).reshape(B, -1)


def awgn_encode_frames(code, numeric, data_bytes, ebn0_db, generator=None, device="cuda"):
    """Alias mirroring ``encode_frames``'s signature plus ``(ebn0_db,
    generator)``."""
    return awgn_symbols(code, numeric, data_bytes, ebn0_db, generator, device)
