"""Depth-2 fused state-blocked ACS for large trellises.

Port of ``acs_update_large2`` from
``ka9q_viterbi_comparison_tpu/ops/pallas/large_k2.py``.  The CUDA kernel is
``acs_large_pair_kernel`` in ``csrc/viterbi_large.cu``: two trellis steps per
launch, the intermediate metrics never leave registers, metrics live in
device memory between launches, and the launch loop runs inside the C
launcher.  An odd step count ends in one ``large_k.acs_update_large`` step,
as in the JAX package.  Beside the wrapper is its plain PyTorch version
(``acs_update_large2_ref``) with the same contract.  A CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.

The renormalisation schedule is the JAX package's, exactly, since it decides
the returned metrics and offset: the entry shift; in-scan shift-to-zero after
pair ``i`` (counted within the call) when ``rn`` and ``i % rn == rn - 1``,
with ``rn`` from ``renorm_schedule``; the odd tail's own entry shift.
Metrics are stored as int32 whatever ``renorm_schedule`` picks as the JAX
package's storage type: the schedule's bound rules out an int16 wrap, so the
values are the same.

``want_g2`` (the radix G_2 planes) is not ported yet.
"""

from __future__ import annotations

import torch

from ...configs import CodeSpec, NumericSpec
from .kernels import _state_order_words
from .large_k import (_check_inputs, _shift_to_zero, acs_update_large_ref, launch_large,
                      metric_dtype_for)

__all__ = ["acs_update_large2", "acs_update_large2_ref", "renorm_schedule"]

DTYPES = {"int16": torch.int16, "int32": torch.int32}


def renorm_schedule(code: CodeSpec, numeric: NumericSpec, T: int,
                    metric_dtype: str | None = None) -> tuple[torch.dtype, int]:
    """``(storage dtype, rn)`` of the JAX package's ``acs_update_large2``
    for a block of ``T`` steps: ``rn`` pairs between in-scan
    renormalisations, 0 for none.  When the whole block's worst-case metric
    overflows int16, renormalising every ``rn`` pairs bounds the spread at
    ``spread + 2 * rn * max_branch_error``; ``metric_dtype="auto"`` then
    turns int16 on if ``rn >= 4``.  Raises for int16 storage that cannot
    hold the spread at all."""
    if metric_dtype is None:
        metric_dtype = numeric.metric_dtype
    if metric_dtype != "auto":
        mdt = DTYPES[metric_dtype]
    else:
        mdt = metric_dtype_for(code, numeric, T)
    rn = 0
    mbe = numeric.max_branch_error(code.R)
    spread = numeric.initial_margin + (code.K - 1) * mbe
    if spread + (T + 8) * mbe >= 30000:
        rn_fit = (29000 - spread) // max(1, 2 * mbe)
        if mdt == torch.int16:
            if rn_fit < 1:
                raise ValueError(
                    f"int16 metrics cannot hold the {numeric.name} spread "
                    f"{spread} even with per-pair renormalisation")
            rn = max(1, int(rn_fit))
        elif metric_dtype == "auto" and rn_fit >= 4:
            mdt = torch.int16
            rn = int(rn_fit)
    return mdt, rn


def acs_update_large2_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                          symbols: torch.Tensor, metric_dtype: str | None = None,
                          time_major: bool = False):
    """Plain version of ``acs_update_large2``: the state-order ACS
    (``ops.acs``) in runs of ``rn`` pairs with a shift-to-zero after each
    whole run, then the odd tail through ``acs_update_large_ref``."""
    _check_inputs(code, metrics, symbols, 8)
    B, T, _ = symbols.shape
    _, rn = renorm_schedule(code, numeric, T, metric_dtype)
    symbols = symbols.to(torch.int32)
    m, offset = _shift_to_zero(metrics.to(torch.int32))
    n = 2 * (T // 2)
    run = 2 * rn if rn else max(n, 1)
    blocks = []
    for t in range(0, n, run):
        m, w = _state_order_words(code, numeric, m, symbols[:, t:min(t + run, n)])
        blocks.append(w)
        if rn and t + run <= n:
            m, shift = _shift_to_zero(m)
            offset = offset + shift
    if T % 2:
        m, w, shift = acs_update_large_ref(code, numeric, m, symbols[:, T - 1:])
        blocks.append(w)
        offset = offset + shift
    words = (torch.cat(blocks, dim=1) if blocks else
             torch.empty((B, 0, code.decision_words), dtype=torch.int32, device=m.device))
    if time_major:
        words = words.transpose(0, 1).contiguous()
    return m, words, offset.to(torch.int32)


def acs_update_large2(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                      symbols: torch.Tensor, metric_dtype: str | None = None,
                      time_major: bool = False):
    """Two-steps-per-launch ACS; the contract of ``acs_update_large``.

    Args:
      metrics: ``[B, S]`` int32.
      symbols: ``[B, T, R]`` int32, ``T >= 1``.
      metric_dtype: ``"auto"``, ``"int16"`` or ``"int32"`` (default: the
        numeric spec's); it selects the renormalisation schedule.
      time_major: return words as ``[T, B, W]`` instead of ``[B, T, W]``.

    Returns ``(metrics [B, S] int32, words int32, offset [B] int32)``;
    ``offset`` is everything the entry shift and the renormalisations
    subtracted (add it back for the true accumulated path error).
    """
    if not metrics.is_cuda:
        return acs_update_large2_ref(code, numeric, metrics, symbols, metric_dtype, time_major)
    _check_inputs(code, metrics, symbols, 8)
    B, T, _ = symbols.shape
    if T < 1:
        raise ValueError("acs_update_large2: no trellis steps")
    _, rn = renorm_schedule(code, numeric, T, metric_dtype)
    W = code.decision_words
    dev = metrics.device
    shape, strides = ((T, B, W), (W, B * W)) if time_major else ((B, T, W), (T * W, W))
    words = torch.empty(shape, dtype=torch.int32, device=dev)
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    m = metrics
    if T >= 2:
        m = launch_large("acs_update_large2", 2, code, numeric, m, symbols, words, offset,
                         strides, 0, T // 2, rn)
    if T % 2:
        # The odd tail: one single-step launch with its own entry shift.
        m = launch_large("acs_update_large", 1, code, numeric, m, symbols, words, offset,
                         strides, T - 1, 1)
    return m, words, offset
