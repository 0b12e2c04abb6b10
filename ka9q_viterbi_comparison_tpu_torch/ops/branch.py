"""Branch-metric machinery.

Port of ``ka9q_viterbi_comparison_tpu/ops/branch.py``.  The penalty of one
trellis step is affine in the symbols:

    penalty[t, (h, b, s2)] = sum_r (sym[t, r] - low)
                           + sum_r E[(h, b)][r, s2] * (high + low - 2 sym[t, r])

where ``E[(h, b)][r, s2]`` is the expected output bit of polynomial ``r`` for
the transition from predecessor ``s2 + h * S/2`` taking input bit ``b``.  One
numpy function (``transition_tables``) serves every path of the port: the
portable torch path, the plain kernel versions and the CUDA kernels, which
receive it packed by ``packed_transition_table``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec

__all__ = [
    "transition_tables",
    "packed_transition_table",
    "branch_penalties",
    "penalty_base_and_coef",
]


@functools.lru_cache(maxsize=None)
def transition_tables(code: CodeSpec) -> np.ndarray:
    """``E[h*2 + b, r, s2]`` (uint8, shape ``[4, R, S/2]``): expected output
    bit of polynomial ``r`` for the trellis transition from predecessor state
    ``s2 + h * S/2`` with input bit ``b``.

    New state is ``2*s2 + b``; its two predecessors are ``s2`` (h=0) and
    ``s2 + S/2`` (h=1) -- the butterfly the reference pairs via its low/high
    metric vector groups (ref: ka9q_libfec_port/viterbi27_sse2.cpp:149-158).
    """
    K = code.K
    half = code.num_states // 2
    ebits = code.expected_bits_table()  # [R, 2S] indexed by register value
    s2 = np.arange(half, dtype=np.int64)
    out = np.empty((4, code.R, half), dtype=np.uint8)
    for h in (0, 1):
        for b in (0, 1):
            reg = ((s2 << 1) | b) | (h << (K - 1))
            out[h * 2 + b] = ebits[:, reg]
    return out


@functools.lru_cache(maxsize=None)
def packed_transition_table(code: CodeSpec) -> np.ndarray:
    """``transition_tables`` folded into one int32 per pair: bit ``8*x + r``
    of entry ``s2`` is ``E[x, r, s2]`` (``[S/2]`` int32, R <= 8).  The layout
    the CUDA kernels read."""
    if code.R > 8:
        raise ValueError(f"{code.name}: R={code.R} > 8 does not pack")
    e = transition_tables(code).astype(np.int64)  # [4, R, S2]
    shifts = (8 * np.arange(4)[:, None] + np.arange(code.R)[None, :])[..., None]
    return (e << shifts).sum(axis=(0, 1)).astype(np.int32)


def penalty_base_and_coef(numeric: NumericSpec, symbols: torch.Tensor):
    """Split symbols ``[..., R]`` int32 into the affine pieces of the branch
    penalty: ``base = sum_r (sym_r - low)`` and ``coef_r = high + low - 2 sym_r``.
    """
    symbols = symbols.to(torch.int32)
    base = (symbols - numeric.soft_low).sum(dim=-1, dtype=torch.int32)
    coef = (numeric.soft_high + numeric.soft_low) - 2 * symbols
    return base, coef


def branch_penalties(
    code: CodeSpec, numeric: NumericSpec, symbols: torch.Tensor
) -> torch.Tensor:
    """Branch penalties ``[..., T, 4, S/2]`` int32 for symbols ``[..., T, R]``.

    Index 1 of the middle axis is ``h*2 + b`` matching ``transition_tables``.
    Materialises the whole block, so only sensible for small trellises.
    """
    half = code.num_states // 2
    e = torch.as_tensor(transition_tables(code), device=symbols.device).to(torch.int32)
    base, coef = penalty_base_and_coef(numeric, symbols)  # [..., T], [..., T, R]
    pen = base[..., None, None].expand(*base.shape, 4, half).clone()
    for r in range(code.R):
        pen += coef[..., r, None, None] * e[:, r]
    return pen
