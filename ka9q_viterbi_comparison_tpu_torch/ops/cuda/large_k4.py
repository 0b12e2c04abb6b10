"""Depth-4 fused state-blocked ACS for large R <= 2 trellises (K=24).

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/large_k4.py``
(``acs_update_large4``, ``acs_update_large4_fields``,
``acs_update_large4_fields8``).  The CUDA kernel is ``acs_large_quad_kernel``
in ``csrc/viterbi_large4.cu``: four trellis steps per launch, all four levels
in a thread's registers, metrics in device memory between launches, the
launch loop inside the C launcher.  It serves every trellis with at least 512
states (K >= 10) at R <= 2.  Beside each wrapper is its plain PyTorch version
(``*_ref``) with the same contract.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.

``acs_update_large4`` returns decision words, as ``acs_update_large2`` does;
the 0-3 steps past the last whole quad run as an ``acs_update_large2`` block
of their own (entry shift, pair, odd tail).

The fields forms return a walk table for ``ops.radix_planes`` instead of
words.  The survivor's predecessor is the traceback's next state, so the
kernel carries each state's last decisions through its levels, ``pf_l =
(pf_{l-1}[winner] << 1) | d_l``, and writes the 4-step field of every final
state nibble-packed (``f4``); over quad pairs the second quad starts from the
first's fields and writes the 8-step field byte-packed (``f8``).  Their first
``lead`` steps run as an ``acs_update_large2`` block whose words are dropped:
callers walk no further back than step ``lead``.

The renormalisation schedules are the JAX package's, exactly, since they
decide the returned metrics and offset (``renorm_schedule4``): quads count
within the call, quad pairs in the f8 form.  Metrics are stored as int32
throughout, as in ``large_k2``.
"""

from __future__ import annotations

import torch

from ...configs import CodeSpec, NumericSpec
from .. import radix_planes as rp
from . import _build
from .kernels import _state_order_words
from .large_k import (_check_inputs, _shift_to_zero, code_args, launch_args, metric_dtype_for,
                      pick_state_block)
from .large_k2 import DTYPES, acs_update_large2_ref, launch_block, words_buffer

__all__ = ["acs_update_large4", "acs_update_large4_ref", "acs_update_large4_fields",
           "acs_update_large4_fields_ref", "acs_update_large4_fields8",
           "acs_update_large4_fields8_ref", "renorm_schedule4", "supports"]

MODE_WORDS, MODE_F4, MODE_F8 = 0, 1, 2


def supports(code: CodeSpec) -> bool:
    """R <= 2 and a state block of sixteen 32-state ranges, the JAX
    package's predicate (K >= 10): one warp of quad threads per frame."""
    return code.R <= 2 and pick_state_block(code) >= 16 * 32


def renorm_schedule4(code: CodeSpec, numeric: NumericSpec, T: int,
                     metric_dtype: str | None = None, steps: int = 4) -> tuple[torch.dtype, int]:
    """``(storage dtype, rn)`` of the JAX package's depth-4 functions for a
    call over ``T`` symbols: ``rn`` units between in-scan renormalisations,
    0 for none; a unit is a quad (``steps=4``: ``acs_update_large4`` and
    ``_fields``) or a quad pair (``steps=8``: ``_fields8``).  As
    ``large_k2.renorm_schedule``, but ``"auto"`` turns int16 on from
    ``rn >= 2``."""
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
        rn_fit = (29000 - spread) // max(1, steps * mbe)
        if mdt == torch.int16:
            if rn_fit < 1:
                raise ValueError(
                    f"int16 metrics cannot hold the {numeric.name} spread "
                    f"{spread} even with per-{'quad' if steps == 4 else 'pair'} renormalisation")
            rn = max(1, int(rn_fit))
        elif metric_dtype == "auto" and rn_fit >= 2:
            mdt = torch.int16
            rn = int(rn_fit)
    return mdt, rn


def _check4(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor) -> None:
    if code.R > 2:
        raise ValueError("depth-4 kernel takes R <= 2")
    _check_inputs(code, metrics, symbols, 10)


def _runs_ref(code, numeric, m, symbols, offset, unit, rn):
    """The state-order ACS over ``symbols`` (a whole number of ``unit``-step
    launches) in runs of ``rn`` units, shifting to zero after each whole
    run: ``(metrics, batch-major words, offset)``."""
    B, n, _ = symbols.shape
    run = unit * rn if rn else max(n, 1)
    blocks = []
    for t in range(0, n, run):
        m, w = _state_order_words(code, numeric, m, symbols[:, t:t + run])
        blocks.append(w)
        if rn and t + run <= n:
            m, shift = _shift_to_zero(m)
            offset = offset + shift
    words = (torch.cat(blocks, dim=1) if blocks else
             torch.empty((B, 0, code.decision_words), dtype=torch.int32, device=m.device))
    return m, words, offset


def acs_update_large4_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                          symbols: torch.Tensor, metric_dtype: str | None = None,
                          time_major: bool = False):
    """Plain version of ``acs_update_large4``: the entry shift, the
    state-order ACS (``ops.acs``) in runs of ``rn`` quads with a shift after
    each whole run, the remainder through ``acs_update_large2_ref``."""
    _check4(code, metrics, symbols)
    B, T, _ = symbols.shape
    _, rn = renorm_schedule4(code, numeric, T, metric_dtype)
    symbols = symbols.to(torch.int32)
    m, offset = _shift_to_zero(metrics.to(torch.int32))
    n = 4 * (T // 4)
    m, words, offset = _runs_ref(code, numeric, m, symbols[:, :n], offset, 4, rn)
    if T % 4:
        m, w, shift = acs_update_large2_ref(code, numeric, m, symbols[:, n:], metric_dtype)
        words = torch.cat([words, w], dim=1)
        offset = offset + shift
    if time_major:
        words = words.transpose(0, 1).contiguous()
    return m, words, offset.to(torch.int32)


def _fields_ref(code, numeric, metrics, symbols, lead, metric_dtype, width):
    _check4(code, metrics, symbols)
    B, T, _ = symbols.shape
    if (T - lead) % width:
        raise ValueError(f"T - lead must be a multiple of {width}, got {T - lead}")
    _, rn = renorm_schedule4(code, numeric, T, metric_dtype, width)
    symbols = symbols.to(torch.int32)
    m = metrics.to(torch.int32)
    offset = torch.zeros((B,), dtype=torch.int32, device=m.device)
    if lead:
        m, _, offset = acs_update_large2_ref(code, numeric, m, symbols[:, :lead], metric_dtype)
    m, shift = _shift_to_zero(m)
    m, words, offset = _runs_ref(code, numeric, m, symbols[:, lead:], offset + shift, width, rn)
    if T == lead:
        table = torch.empty((0, width, B, code.decision_words), dtype=torch.int32, device=m.device)
    else:
        table = rp.build_plane_tables(code, words.transpose(0, 1), 0, None, width)[f"f{width}"]
    return m, table, offset.to(torch.int32)


def acs_update_large4_fields_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                                 symbols: torch.Tensor, lead: int = 0,
                                 metric_dtype: str | None = None):
    """Plain version of ``acs_update_large4_fields``: ``lead`` steps through
    ``acs_update_large2_ref``, the shift to zero, the state-order ACS in runs
    of ``rn`` quads, then ``radix_planes.build_plane_tables`` over those
    words."""
    return _fields_ref(code, numeric, metrics, symbols, lead, metric_dtype, 4)


def acs_update_large4_fields8_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                                  symbols: torch.Tensor, lead: int = 0,
                                  metric_dtype: str | None = None):
    """Plain version of ``acs_update_large4_fields8``: as
    ``acs_update_large4_fields_ref`` in runs of ``rn`` quad pairs, building
    the width-8 table."""
    return _fields_ref(code, numeric, metrics, symbols, lead, metric_dtype, 8)


def launch_quads(counter: str, mode: int, code: CodeSpec, numeric: NumericSpec,
                 metrics: torch.Tensor, symbols: torch.Tensor, table: torch.Tensor,
                 offset: torch.Tensor, strides: tuple[int, int], t0: int, nl: int,
                 rn: int) -> torch.Tensor:
    """Check and call the launcher of ``csrc/viterbi_large4.cu``: ``nl``
    launches of the quad kernel from step ``t0`` of ``symbols``,
    renormalising every ``rn`` launches.  ``table``: the words (``strides``:
    their frame and step strides) or the f4 / f8 table.  Returns the final
    metrics ``[B, S]`` int32; ``table`` and ``offset`` are filled in place."""
    m_out, scratch, _alive = launch_args(code, metrics, symbols, offset, nl, rn)
    B = metrics.shape[0]
    f4_tmp = (torch.empty((4, B, code.decision_words), dtype=torch.int32, device=metrics.device)
              if mode == MODE_F8 else None)
    _build.launch(counter, "viterbi_acs_large4", metrics.device, mode, *scratch[:5],
                  table.data_ptr(), f4_tmp.data_ptr() if f4_tmp is not None else None,
                  *scratch[5:], *code_args(code, numeric), *symbols.shape[:2], t0, nl, rn, *strides)
    return m_out


def acs_update_large4(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                      symbols: torch.Tensor, metric_dtype: str | None = None,
                      time_major: bool = False):
    """Four-steps-per-launch ACS; the contract of ``acs_update_large2``
    (without ``want_g2``).

    Args:
      metrics: ``[B, S]`` int32, ``S >= 512``.
      symbols: ``[B, T, R]`` int32, ``R <= 2``, ``T >= 1``.
      metric_dtype: ``"auto"``, ``"int16"`` or ``"int32"`` (default: the
        numeric spec's); it selects the renormalisation schedules.
      time_major: return words as ``[T, B, W]`` instead of ``[B, T, W]``.

    Returns ``(metrics [B, S] int32, words int32, offset [B] int32)``.
    """
    if not metrics.is_cuda:
        return acs_update_large4_ref(code, numeric, metrics, symbols, metric_dtype, time_major)
    _check4(code, metrics, symbols)
    B, T, _ = symbols.shape
    if T < 1:
        raise ValueError("acs_update_large4: no trellis steps")
    _, rn = renorm_schedule4(code, numeric, T, metric_dtype)
    words, strides = words_buffer(B, T, code.decision_words, time_major, metrics.device)
    offset = torch.zeros((B,), dtype=torch.int32, device=metrics.device)
    m = metrics
    if T >= 4:
        m = launch_quads("acs_update_large4", MODE_WORDS, code, numeric, m, symbols, words,
                         offset, strides, 0, T // 4, rn)
    if T % 4:
        m = launch_block(code, numeric, m, symbols, words, offset, strides, 4 * (T // 4), T % 4,
                         metric_dtype)
    return m, words, offset


def _fields(counter, mode, code, numeric, metrics, symbols, lead, metric_dtype):
    width = 8 if mode == MODE_F8 else 4
    _check4(code, metrics, symbols)
    B, T, _ = symbols.shape
    if (T - lead) % width:
        raise ValueError(f"T - lead must be a multiple of {width}, got {T - lead}")
    _, rn = renorm_schedule4(code, numeric, T, metric_dtype, width)
    W = code.decision_words
    dev = metrics.device
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    m = metrics
    if lead:
        dropped, strides = words_buffer(B, lead, W, False, dev)
        m = launch_block(code, numeric, m, symbols, dropped, offset, strides, 0, lead, metric_dtype)
    table = torch.empty(((T - lead) // width, width, B, W), dtype=torch.int32, device=dev)
    if T == lead:
        m, shift = _shift_to_zero(m)
        return m, table, offset + shift
    m = launch_quads(counter, mode, code, numeric, m, symbols, table, offset, (0, 0), lead,
                     (T - lead) // 4, rn * (width // 4))
    return m, table, offset


def acs_update_large4_fields(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                             symbols: torch.Tensor, lead: int = 0,
                             metric_dtype: str | None = None):
    """Depth-4 update that returns the width-4 walk table and no words.

    The first ``lead`` steps run on ``acs_update_large2``; the other
    ``T - lead`` (a multiple of 4) on the quad kernel in fields mode.

    Returns ``(metrics [B, S] int32, f4 [(T - lead) / 4, 4, B, W] int32,
    offset [B] int32)``; window ``p`` of ``f4`` covers steps ``[lead + 4p,
    lead + 4p + 4)`` in the layout of ``radix_planes.build_plane_tables``
    (state ``s`` in nibble ``(s >> 2) & 7`` of word ``(s & 3, s >> 5)``).
    """
    if not metrics.is_cuda:
        return acs_update_large4_fields_ref(code, numeric, metrics, symbols, lead, metric_dtype)
    return _fields("acs_update_large4_fields", MODE_F4, code, numeric, metrics, symbols, lead,
                   metric_dtype)


def acs_update_large4_fields8(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                              symbols: torch.Tensor, lead: int = 0,
                              metric_dtype: str | None = None):
    """Depth-4 update over quad pairs that returns the width-8 walk table.

    Of each pair the first quad leaves its f4 table as the only hand-off and
    the second, starting from those fields at its predecessors, writes the
    8-step fields.  ``T - lead`` must be a multiple of 8.

    Returns ``(metrics [B, S] int32, f8 [(T - lead) / 8, 8, B, W] int32,
    offset [B] int32)``; window ``p`` of ``f8`` covers steps ``[lead + 8p,
    lead + 8p + 8)`` (state ``s`` in byte ``s & 3`` of word ``((s >> 2) & 7,
    s >> 5)``).
    """
    if not metrics.is_cuda:
        return acs_update_large4_fields8_ref(code, numeric, metrics, symbols, lead, metric_dtype)
    return _fields("acs_update_large4_fields8", MODE_F8, code, numeric, metrics, symbols, lead,
                   metric_dtype)
