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

``want_g2`` adds the radix G_2 plane of every step pair
(``ops.radix_planes``): for the state ``s`` that survives step ``t+1``, the
step-``t`` decision at the predecessor ``s`` came from, packed like the
step-``t+1`` words.  The kernel selects it in registers from both steps'
decisions; the plain version gathers it from the words.
"""

from __future__ import annotations

import torch

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import pack_bits_to_words, unpack_words_to_bits
from .kernels import _state_order_words
from .large_k import (_check_inputs, _shift_to_zero, acs_update_large_ref, launch_large,
                      metric_dtype_for)

__all__ = ["acs_update_large2", "acs_update_large2_ref", "renorm_schedule", "launch_block"]

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


def g2_from_words(code: CodeSpec, words: torch.Tensor) -> torch.Tensor:
    """The G_2 planes ``[B, T // 2, W]`` of batch-major words ``[B, T, W]``,
    state by state: bit ``s`` of pair ``i`` is the step-``2i`` decision at
    ``(s >> 1) | (d << (K-2))``, ``d`` the step-``2i+1`` decision at ``s``."""
    B, T, W = words.shape
    n = T // 2
    bits = unpack_words_to_bits(words[:, :2 * n]).reshape(B, n, 2, code.num_states).long()
    s = torch.arange(code.num_states, device=words.device)
    pred = (s >> 1) + (bits[:, :, 1] << (code.K - 2))
    return pack_bits_to_words(bits[:, :, 0].gather(2, pred))


def acs_update_large2_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                          symbols: torch.Tensor, metric_dtype: str | None = None,
                          time_major: bool = False, want_g2: bool = False):
    """Plain version of ``acs_update_large2``: the state-order ACS
    (``ops.acs``) in runs of ``rn`` pairs with a shift-to-zero after each
    whole run, then the odd tail through ``acs_update_large_ref``; the G_2
    planes by ``g2_from_words``."""
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
    g2 = g2_from_words(code, words) if want_g2 else None
    if time_major:
        words = words.transpose(0, 1).contiguous()
        g2 = g2.transpose(0, 1).contiguous() if want_g2 else None
    if want_g2:
        return m, words, g2, offset.to(torch.int32)
    return m, words, offset.to(torch.int32)


def launch_block(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                 symbols: torch.Tensor, words: torch.Tensor, offset: torch.Tensor,
                 strides: tuple[int, int], t0: int, T: int, metric_dtype: str | None = None,
                 g2: torch.Tensor | None = None, g2_strides: tuple[int, int] = (0, 0)):
    """Steps ``[t0, t0 + T)`` of ``symbols`` as one ``acs_update_large2``
    block on the card: ``T // 2`` launches of the pair kernel on the schedule
    of a ``T``-step block, then the odd tail as one launch of the step
    kernel with its own entry shift.  Returns the metrics; ``words``,
    ``offset`` and ``g2`` are filled in place."""
    _, rn = renorm_schedule(code, numeric, T, metric_dtype)
    m = metrics
    if T >= 2:
        m = launch_large("acs_update_large2", 2, code, numeric, m, symbols, words, offset,
                         strides, t0, T // 2, rn, g2, g2_strides)
    if T % 2:
        m = launch_large("acs_update_large", 1, code, numeric, m, symbols, words, offset,
                         strides, t0 + T - 1, 1)
    return m


def acs_update_large2(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                      symbols: torch.Tensor, metric_dtype: str | None = None,
                      time_major: bool = False, want_g2: bool = False):
    """Two-steps-per-launch ACS; the contract of ``acs_update_large``.

    Args:
      metrics: ``[B, S]`` int32.
      symbols: ``[B, T, R]`` int32, ``T >= 1``.
      metric_dtype: ``"auto"``, ``"int16"`` or ``"int32"`` (default: the
        numeric spec's); it selects the renormalisation schedule.
      time_major: return words (and ``g2``) as ``[T, B, W]`` instead of
        ``[B, T, W]``.
      want_g2: also return the G_2 planes ``[B, T // 2, W]`` int32.

    Returns ``(metrics [B, S] int32, words int32, offset [B] int32)``, or
    with ``want_g2`` ``(metrics, words, g2, offset)`` as the JAX package
    orders them; ``offset`` is everything the entry shift and the
    renormalisations subtracted (add it back for the true accumulated path
    error).
    """
    if not metrics.is_cuda:
        return acs_update_large2_ref(code, numeric, metrics, symbols, metric_dtype, time_major,
                                     want_g2)
    _check_inputs(code, metrics, symbols, 8)
    B, T, _ = symbols.shape
    if T < 1:
        raise ValueError("acs_update_large2: no trellis steps")
    W = code.decision_words
    dev = metrics.device
    words, strides = words_buffer(B, T, W, time_major, dev)
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    g2, g2_strides = words_buffer(B, T // 2, W, time_major, dev) if want_g2 else (None, (0, 0))
    m = launch_block(code, numeric, metrics, symbols, words, offset, strides, 0, T, metric_dtype,
                     g2, g2_strides)
    if want_g2:
        return m, words, g2, offset
    return m, words, offset


def words_buffer(B: int, T: int, W: int, time_major: bool, device: torch.device):
    """An empty words tensor, ``[T, B, W]`` or ``[B, T, W]``, and its (frame,
    step) strides as the launchers take them."""
    shape, strides = ((T, B, W), (W, B * W)) if time_major else ((B, T, W), (T * W, W))
    return torch.empty(shape, dtype=torch.int32, device=device), strides
