"""What the entry kinds share: the port's specs for a configuration file,
the seed's generator on the device, and the counts of what differs."""

from __future__ import annotations

import torch

from ka9q_viterbi_comparison_tpu_torch import CodeSpec, NumericSpec

__all__ = ["port_specs", "generator", "mismatch", "bit_errors"]


def port_specs(cfg: dict) -> tuple[CodeSpec, NumericSpec]:
    """The port's code and numeric spec for a configuration file."""
    code = CodeSpec(cfg["name"], K=int(cfg["K"]), R=len(cfg["polys"]),
                    polys=tuple(int(p) for p in cfg["polys"]))
    numeric = NumericSpec(name=cfg["numeric"], soft_high=int(cfg["soft_high"]),
                          soft_low=int(cfg["soft_low"]),
                          initial_margin=int(cfg["initial_margin"]))
    return code, numeric


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def mismatch(out: torch.Tensor, want: torch.Tensor) -> int:
    """Elements of ``out`` that differ from ``want``; all of them where the
    shapes differ."""
    if tuple(out.shape) != tuple(want.shape):
        return max(want.numel(), out.numel())
    return int((out.to(want.device, torch.int64) != want.to(torch.int64)).sum())


def bit_errors(out: torch.Tensor, data: torch.Tensor) -> int:
    """Bits of the bytes ``out`` that differ from the data bytes ``data``."""
    if tuple(out.shape) != tuple(data.shape):
        return 8 * data.numel()
    x = (out.to(data.device) ^ data).to(torch.int64)
    return int(sum(((x >> i) & 1).sum() for i in range(8)))
