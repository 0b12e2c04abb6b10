"""Single-step state-blocked ACS for large trellises.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/large_k.py``
(``acs_update_large``, ``pick_state_block``, ``metric_dtype_for``,
``_shift_to_zero``).  The CUDA kernel is ``acs_large_step_kernel`` in
``csrc/viterbi_large.cu``: metrics stay in device memory, one launch per
trellis step, the launch loop inside the C launcher.  Beside the wrapper is
its plain PyTorch version (``acs_update_large_ref``) with the same contract.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

Layout is batch-major: metrics ``[B, S]`` in state order, symbols
``[B, T, R]``, decision words ``[B, T, W]`` (int32 holding uint32 bits, bit
``s % 32`` of word ``s // 32`` for new state ``s``).  Every call first
shifts each frame's metrics to a minimum of zero and returns the shift as the
offset, as the JAX package does.  Metrics are stored as int32 in every case:
the JAX package's int16 storage (``metric_dtype_for``) holds the same
values, since its bound rules out a wrap.
"""

from __future__ import annotations

import ctypes

import torch

from ...configs import CodeSpec, NumericSpec
from . import _build
from .kernels import _state_order_words

__all__ = ["acs_update_large", "acs_update_large_ref", "pick_state_block", "metric_dtype_for",
           "MAX_BLOCK", "PACK"]

MAX_BLOCK = 1 << 17  # states per grid block of the Pallas kernels
PACK = 32            # states per packed decision word
INT32_MAX = 2**31 - 1


def pick_state_block(code: CodeSpec) -> int:
    return min(code.num_states, MAX_BLOCK)


def metric_dtype_for(code: CodeSpec, numeric: NumericSpec, T: int) -> torch.dtype:
    """int16 when the worst-case metric reachable within one update block
    fits with headroom, else int32 (the JAX package's storage choice).  The
    spread of a Viterbi metric vector never exceeds ``initial_margin +
    (K-1) * max_branch_error``; blocks start shifted to zero."""
    mbe = numeric.max_branch_error(code.R)
    spread = numeric.initial_margin + (code.K - 1) * mbe
    worst = spread + (T + 8) * mbe
    return torch.int16 if worst < 30000 else torch.int32


def _shift_to_zero(metrics: torch.Tensor):
    """Per-frame shift-to-zero renormalisation: ``(metrics - min, min)``.  A
    per-frame constant changes no compare-select decision, and the returned
    shift keeps the accumulated path metric exact."""
    shift = metrics.min(dim=1).values
    return metrics - shift[:, None], shift


def _check_inputs(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor, k_min: int):
    if code.K < k_min:
        raise ValueError(f"{code.name}: K={code.K} < {k_min}, below the state-blocked "
                         f"kernel's smallest block (a warp of threads per frame)")
    B, S = metrics.shape
    if S != code.num_states or symbols.shape[0] != B or symbols.shape[2] != code.R:
        raise ValueError(f"metrics {tuple(metrics.shape)} / symbols {tuple(symbols.shape)} "
                         f"do not match {code.name}")


def acs_update_large_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                         symbols: torch.Tensor):
    """Plain version of ``acs_update_large``: the entry shift, then the
    state-order ACS (``ops.acs``) over every step."""
    _check_inputs(code, metrics, symbols, 7)
    m, shift = _shift_to_zero(metrics.to(torch.int32))
    m, words = _state_order_words(code, numeric, m, symbols.to(torch.int32))
    return m, words, shift.to(torch.int32)


def launch_large(counter: str, steps: int, code: CodeSpec, numeric: NumericSpec,
                 metrics: torch.Tensor, symbols: torch.Tensor, words: torch.Tensor,
                 offset: torch.Tensor, word_strides: tuple[int, int], t0: int, nl: int,
                 rn: int = 0, g2: torch.Tensor | None = None,
                 g2_strides: tuple[int, int] = (0, 0), shifts: bool = True) -> torch.Tensor:
    """Check and call the streaming launcher of ``csrc/viterbi_large.cu``:
    ``nl`` launches of the pair (``steps=2``) or step (``steps=1``) kernel
    from step ``t0`` of ``symbols``, renormalising every ``rn`` launches.
    Returns the final metrics ``[B, S]`` int32; ``words`` and ``offset`` (and
    ``g2``, the pair kernel's optional G_2 planes) are filled in place (the
    offset accumulates).  ``shifts=False`` (with ``rn = 0``): no entry shift
    either, for launches whose shifts a later one subsumes."""
    m_out, scratch, _alive = launch_args(code, metrics, symbols, offset, nl, rn, shifts)
    _build.launch(counter, "viterbi_acs_large", metrics.device, steps, *scratch[:5],
                  words.data_ptr(), g2.data_ptr() if g2 is not None else None, *scratch[5:],
                  *code_args(code, numeric), *symbols.shape[:2], t0, nl, rn, *word_strides,
                  *g2_strides)
    return m_out


def launch_args(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor,
                offset: torch.Tensor, nl: int, rn: int, shifts: bool = True):
    """What the launchers of the state-blocked kernels share: the checks, the
    output and ping-pong metric buffers, and the ``[rows, B]`` buffer of
    pending shifts (the entry shift and one row per renormalisation, every
    ``rn`` of ``nl`` launches; no row, and no shift, with
    ``shifts=False``).  Returns ``(m_out, (m_in, symbols, polys,
    m_out, m_tmp | offset, mins, rows), scratch tensors)``: the pointers as
    the launchers take them, and the tensors the caller keeps until it has
    launched."""
    B, T, R = symbols.shape
    _build.check_cuda_int32("metrics", metrics, (B, code.num_states))
    _build.check_cuda_int32("symbols", symbols, (B, T, R))
    _build.check_cuda_int32("offset", offset, (B,))
    m_out = torch.empty_like(metrics)
    m_tmp = torch.empty_like(metrics)
    if not shifts and rn:
        raise ValueError("launch_args: a renormalisation schedule needs shifts")
    nmins = 1 + (nl // rn if rn else 0) if shifts else 0
    mins = torch.full((max(nmins, 1), B), INT32_MAX, dtype=torch.int32, device=metrics.device)
    polys = (ctypes.c_int * R)(*code.abs_polys())
    return m_out, (metrics.data_ptr(), symbols.data_ptr(), polys, m_out.data_ptr(),
                   m_tmp.data_ptr(), offset.data_ptr(), mins.data_ptr(), nmins), (m_tmp, mins)


def code_args(code: CodeSpec, numeric: NumericSpec) -> tuple[int, int, int, int, int]:
    """``(K, R, inv, low, high + low)`` of the launchers' signatures."""
    inv = sum(1 << r for r, i in enumerate(code.inversions()) if i)
    return code.K, code.R, inv, numeric.soft_low, numeric.soft_high + numeric.soft_low


def acs_update_large(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                     symbols: torch.Tensor):
    """ACS over a whole block, one launch per trellis step.

    Args:
      metrics: ``[B, S]`` int32.
      symbols: ``[B, T, R]`` int32, ``T >= 1``.

    Returns ``(metrics [B, S] int32, words [B, T, W] int32, offset [B]
    int32)``; ``offset`` is the block-entry shift (add it back for the true
    accumulated path error).
    """
    if not metrics.is_cuda:
        return acs_update_large_ref(code, numeric, metrics, symbols)
    _check_inputs(code, metrics, symbols, 7)
    B, T, _ = symbols.shape
    if T < 1:
        raise ValueError("acs_update_large: no trellis steps")
    W = code.decision_words
    words = torch.empty((B, T, W), dtype=torch.int32, device=metrics.device)
    offset = torch.zeros((B,), dtype=torch.int32, device=metrics.device)
    m = launch_large("acs_update_large", 1, code, numeric, metrics, symbols, words, offset,
                     (T * W, W), 0, T)
    return m, words, offset
