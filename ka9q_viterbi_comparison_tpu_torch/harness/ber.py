"""BER-vs-Eb/N0 evaluation.

Port of ``ka9q_viterbi_comparison_tpu/harness/ber.py``.  The reference carries
full soft-decision machinery but never exercises it with noise (SURVEY §4);
this module measures the thing soft decisions exist for: the coded bit-error
rate across AWGN operating points, batched on the device.

The frames come from ``np.random.default_rng(seed)``, as in the JAX function;
the noise from a ``torch.Generator`` on the device seeded with ``seed`` (not
the JAX package's noise: ``jax.random`` streams are not reproducible here).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import resolve_device
from ..models.functional import decode_symbols
from ..ops.channel import awgn_symbols
from ..utils.bits import count_bit_errors

__all__ = ["BerPoint", "measure_ber", "ber_curve"]


@dataclasses.dataclass
class BerPoint:
    ebn0_db: float
    bits: int
    errors: int
    frames: int
    frame_errors: int

    @property
    def ber(self) -> float:
        return self.errors / self.bits if self.bits else 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / self.frames if self.frames else 0.0

    def ber_ci(self, z: float = 1.96) -> tuple[float, float]:
        """95 % Wilson score interval for the BER (binomial ``errors`` out of
        ``bits``).  Bit errors within one frame are correlated (error events
        span several trellis steps), so the binomial interval is
        anti-conservative at the margin; ``min_errors`` is the primary
        control."""
        n = self.bits
        if not n:
            return (0.0, 0.0)
        p = self.errors / n
        denom = 1 + z * z / n
        center = (p + z * z / (2 * n)) / denom
        half = (z / denom) * ((p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5)
        return (max(center - half, 0.0), min(center + half, 1.0))

    @property
    def uncoded_ber(self) -> float:
        """Uncoded BPSK BER at the same Eb/N0: Q(sqrt(2 Eb/N0))."""
        ebn0 = 10 ** (self.ebn0_db / 10)
        return 0.5 * math.erfc(math.sqrt(ebn0))


def measure_ber(
    code: CodeSpec,
    numeric: NumericSpec,
    ebn0_db: float,
    frame_bytes: int = 128,
    batch: int = 64,
    min_errors: int = 100,
    max_bits: int = 10_000_000,
    seed: int = 0,
    decode=None,
    device: torch.device | str = "cuda",
) -> BerPoint:
    """Monte-Carlo BER at one operating point: decode batches of AWGN frames
    until ``min_errors`` bit errors or ``max_bits`` decoded.

    ``decode(symbols [B, T*R] on device) -> bytes [B, N]`` defaults to the
    port's ``decode_symbols`` on the kernels."""
    device = resolve_device(device)
    if decode is None:
        def decode(syms):
            return decode_symbols(code, numeric, syms, frame_bytes * 8, device=device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    bits = errors = frames = frame_errors = 0
    while errors < min_errors and bits < max_bits:
        data = rng.integers(0, 256, size=(batch, frame_bytes), dtype=np.uint8)
        syms = awgn_symbols(code, numeric, data, ebn0_db, gen, device)
        out = decode(syms)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        errors += count_bit_errors(out, data)
        frame_errors += int((out != data).any(axis=1).sum())
        frames += batch
        bits += batch * frame_bytes * 8
    return BerPoint(ebn0_db, bits, errors, frames, frame_errors)


def ber_curve(
    code: CodeSpec,
    numeric: NumericSpec,
    ebn0_points: list[float],
    **kwargs,
) -> list[BerPoint]:
    return [measure_ber(code, numeric, p, **kwargs) for p in ebn0_points]
