"""Depth-4 fused state-blocked ACS for large R <= 2 trellises (K=24).

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/large_k4.py``
(``acs_update_large4``, ``acs_update_large4_fields``,
``acs_update_large4_fields8``).  The CUDA kernel is ``acs_large_quad_kernel``
in ``csrc/viterbi_large4.cu``: eight trellis steps per launch (an octet: two
four-level quads in a thread's registers with one transpose through shared
memory between them), metrics in device memory between launches, the launch
loop inside the C launcher; a call of an odd number of quads ends in one
four-step launch.  It serves every trellis with at least 512 states (K >= 10)
at R <= 2.  Beside each wrapper is its plain PyTorch version (``*_ref``) with
the same contract.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.

``acs_update_large4`` returns decision words, as ``acs_update_large2`` does;
the 1-3 steps past the last whole quad run as an ``acs_update_large2`` block
of their own (entry shift, pair, odd tail), or, three of them with no
in-scan renormalisation, with the last quad as one 7-step launch (a quad and
a three-level tri).  One or two of them with no in-scan renormalisation,
where the frame streams (K >= 18), take their entry shift from the last quad
launch, which leaves the frame minimum of its finals (``fin=2``): the
remainder is one pass.  ``large_k.acs_update_large`` runs the same launches
with the entry shift only.

The fields forms return a walk table for ``ops.radix_planes`` instead of
words.  The survivor's predecessor is the traceback's next state, so the
kernel carries each state's last decisions through its levels, ``pf_l =
(pf_{l-1}[winner] << 1) | d_l``, and writes the 4-step field of every final
state nibble-packed (``f4``, two windows an octet); in the f8 form the
octet's second quad starts from the first's fields and writes the 8-step
field byte-packed (``f8``).  Their first ``lead`` steps run on the words form
(counted as ``acs_update_large4``: one launch for a lead of 3 or 7 steps, a
tri or a quad and a tri; else whole quads and an ``acs_update_large2``
block), whose words are dropped: callers walk no further back than step
``lead``.

The renormalisation schedules are the JAX package's, exactly, since they
decide the returned metrics and offset (``renorm_schedule4``): quads count
within the call, quad pairs (octets) in the f8 form; a shift that falls
between the two quads of an octet is taken there as the frame minimum and
subtracted as the next launch reads.  Metrics are stored as int32
throughout, as in ``large_k2``, so a shift that a later one follows changes
neither the returned metrics nor the offset (the ACS commutes with a uniform
shift): the launches skip those that cost a pass over the metrics (the
shifts inside the lead steps and of their remainder, the shift of a
remainder after the quads), all but a call's entry shift, which its first
launch takes so that entry metrics near the int32 limit cannot wrap.
"""

from __future__ import annotations

import torch

from ...configs import CodeSpec, NumericSpec
from ...utils.spans import span
from .. import radix_planes as rp
from . import _build, large_k
from .kernels import _state_order_words
from .large_k import (_check_inputs, _shift_to_zero, code_args, launch_args, metric_dtype_for,
                      pick_state_block)
from .large_k2 import DTYPES, acs_update_large2_ref, chip_blocks, launch_block, words_buffer

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
                 offset: torch.Tensor, strides: tuple[int, int], t0: int, nq: int,
                 rn: int, tail: int = 0,
                 entry: torch.Tensor | None = None, fin: int = 0, fresh: bool = False):
    """Check and call the launcher of ``csrc/viterbi_large4.cu``: ``nq``
    quads from step ``t0`` of ``symbols`` (``nq // 2`` octet launches, then a
    lone quad for odd ``nq``), renormalising after every ``rn``-th quad,
    then ``tail`` (0 or 3, words form) steps that run with the last quad as
    one 7-step launch.  ``table``: the words (``strides``: their frame and
    step strides) or the f4 / f8 table.  ``entry``: a ``[B]`` row holding
    the entry shift, computed by an earlier call (else the first launch
    takes the frame minimum of ``metrics``).  ``fin`` (with ``rn = 0``): 2 returns the frame
    minimum of the final metrics, unsubtracted, for the next call's entry; 3
    (with the tail) shifts by the minimum before the last step.  ``fresh``:
    the entry minimum's pass zeroes ``offset`` first.  Returns the final
    metrics ``[B, S]`` int32, and with ``fin=2`` that minimum; ``table`` and
    ``offset`` are filled in place."""
    lq = max(nq - 1, 0) if tail else nq  # quads before the tail's launch
    launches = lq // 2 + lq % 2 + (1 if tail else 0)
    nmins = (1 if entry is None else 0) + (nq // rn if rn else 0)
    m_out, scratch, _alive = launch_args(code, metrics, symbols, offset, launches, nmins,
                                         fill=rn > 0)
    B = metrics.shape[0]
    fmin = (torch.full((B,), large_k.INT32_MAX, dtype=torch.int32, device=metrics.device)
            if fin else None)
    _build.launch(counter, "viterbi_acs_large4", metrics.device, mode, *scratch[:5],
                  table.data_ptr(), *scratch[5:], entry.data_ptr() if entry is not None else None,
                  fmin.data_ptr() if fmin is not None else None, fin, int(fresh),
                  *code_args(code, numeric),
                  *symbols.shape[:2], t0, nq, tail, rn, *strides)
    return (m_out, fmin) if fin == 2 else m_out


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
    with span("ka9q.alloc"):  # a call's words (730 MB at ICE B=8 T=87) and offset
        words, strides = words_buffer(B, T, code.decision_words, time_major, metrics.device)
        offset = torch.zeros((B,), dtype=torch.int32, device=metrics.device)
    m = metrics
    if T % 4 in (1, 2) and T > 4 and rn == 0 and not chip_blocks(code, B):
        # The remainder's entry shift is the frame minimum after the quads,
        # which their last launch takes: the remainder is one pass.
        m, entry = launch_quads("acs_update_large4", MODE_WORDS, code, numeric, m, symbols, words,
                                offset, strides, 0, T // 4, 0, fin=2)
        m = launch_block(code, numeric, m, symbols, words, offset, strides, 4 * (T // 4), T % 4,
                         metric_dtype, entry=entry)
        return m, words, offset
    if T % 4 == 3 and T > 4 and rn == 0:
        # The remainder's shifts (its entry, its tail's entry) add up to the
        # minimum before the last step: the last quad and the remainder run
        # as one 7-step launch, which shifts by that minimum.
        m = launch_quads("acs_update_large4", MODE_WORDS, code, numeric, m, symbols, words,
                         offset, strides, 0, T // 4, 0, 3, fin=3)
        return m, words, offset
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
    entry = None
    if lead in (3, 7) and T > lead:
        # The lead steps as one launch (a 3-step tri, or a quad and a tri)
        # after the call's entry shift, whose words are dropped and whose
        # final frame minimum is the quads' entry shift.
        dropped, strides = words_buffer(B, lead, W, False, dev)
        m, entry = launch_quads("acs_update_large4", MODE_WORDS, code, numeric, m, symbols,
                                dropped, offset, strides, 0, lead // 4, 0, 3, fin=2)
    elif lead:  # whole quads, then pairs; the shift after the lead steps subsumes theirs
        dropped, strides = words_buffer(B, lead, W, False, dev)
        if lead >= 4:
            m = launch_quads("acs_update_large4", MODE_WORDS, code, numeric, m, symbols, dropped,
                             offset, strides, 0, lead // 4, 0)
        if lead % 4:
            # The call's entry shift where no quad took it.
            m = launch_block(code, numeric, m, symbols, dropped, offset, strides, lead - lead % 4,
                             lead % 4, metric_dtype, shifts=lead < 4)
    table = torch.empty(((T - lead) // width, width, B, W), dtype=torch.int32, device=dev)
    if T == lead:
        m, shift = _shift_to_zero(m)
        return m, table, offset + shift
    m = launch_quads(counter, mode, code, numeric, m, symbols, table, offset, (0, 0), lead,
                     (T - lead) // 4, rn * (width // 4), entry=entry)
    return m, table, offset


def acs_update_large4_fields(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                             symbols: torch.Tensor, lead: int = 0,
                             metric_dtype: str | None = None):
    """Depth-4 update that returns the width-4 walk table and no words.

    The first ``lead`` steps run on the words form (their words dropped);
    the other ``T - lead`` (a multiple of 4) on the octet kernel in fields
    mode.

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

    Each quad pair is one octet launch: the first quad's 4-bit fields cross
    the octet's transpose in shared memory and seed the second's, which
    writes the 8-step fields.  ``T - lead`` must be a multiple of 8.

    Returns ``(metrics [B, S] int32, f8 [(T - lead) / 8, 8, B, W] int32,
    offset [B] int32)``; window ``p`` of ``f8`` covers steps ``[lead + 8p,
    lead + 8p + 8)`` (state ``s`` in byte ``s & 3`` of word ``((s >> 2) & 7,
    s >> 5)``).
    """
    if not metrics.is_cuda:
        return acs_update_large4_fields8_ref(code, numeric, metrics, symbols, lead, metric_dtype)
    return _fields("acs_update_large4_fields8", MODE_F8, code, numeric, metrics, symbols, lead,
                   metric_dtype)
