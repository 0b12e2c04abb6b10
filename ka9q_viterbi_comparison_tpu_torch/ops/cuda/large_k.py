"""State-blocked ACS for large trellises, with the entry shift only.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/large_k.py``
(``acs_update_large``, ``pick_state_block``, ``metric_dtype_for``,
``_shift_to_zero``).  The JAX function scans a one-step kernel with the
metrics in device memory; the port computes the same function in one of
three forms, picked by ``plan`` on the shape alone:

* on chip (``large_k2.chip_blocks > 0``: K = 8..17 where a block has a
  pair's table entries; Cassini): one launch of ``acs_pairs_chip_kernel``
  for the whole call, a frame's metrics in a cluster's shared memory, the
  entry shift a cluster reduction, no shift before the odd step;
* octets (the frame streams and ``large_k4.supports``: K >= 18 at R <= 2;
  ICE): the entry minimum, the octet kernel (eight steps a pass) over the
  whole quads, then the 1-3 steps left (with the last quad as one 7-step
  launch, or one streaming pair or step launch), no shift after the entry's;
* streaming (every other shape: K = 7; K = 8..11 at R >= 5; K >= 18 at
  R > 2): the entry minimum, ``acs_large_pair_kernel`` (two steps a pass),
  then ``acs_large_step_kernel`` for an odd T; at K = 7, whose pair block
  would be under a warp, the step kernel every step.

The kernels are in ``csrc/viterbi_large.cu`` and ``csrc/viterbi_large4.cu``,
the launch loops inside their C launchers.  The entry minimum's pass
(``frame_min_kernel``) also zeroes the offset, so a call fills no buffer.
Beside the wrapper is its plain PyTorch version (``acs_update_large_ref``)
with the same contract, and ``plan_ref``, the plan's segments on the plain
ACS.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernels or raises.

Layout is batch-major: metrics ``[B, S]`` in state order, symbols
``[B, T, R]``, decision words ``[B, T, W]`` (int32 holding uint32 bits, bit
``s % 32`` of word ``s // 32`` for new state ``s``).  Every call first
shifts each frame's metrics to a minimum of zero and returns the shift as the
offset, as the JAX package does, before any candidate is added (entry metrics
near the int32 limit cannot wrap).  Metrics are stored as int32 in every
case: the JAX package's int16 storage (``metric_dtype_for``) holds the same
values, since its bound rules out a wrap.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...configs import CodeSpec, NumericSpec
from . import _build
from .kernels import _state_order_words

__all__ = ["acs_update_large", "acs_update_large_ref", "plan", "plan_ref", "Plan",
           "pick_state_block", "metric_dtype_for", "MAX_BLOCK", "MAX_CALL_B", "PACK"]

MAX_BLOCK = 1 << 17  # states per grid block of the Pallas kernels
# Frames a call on the card: every form's launch puts the frames on a grid's y
# extent.  A deliberate difference from the JAX package, which has no cap.
MAX_CALL_B = 65535
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


@dataclasses.dataclass(frozen=True)
class Plan:
    """How ``acs_update_large`` runs a call on the card.

    ``form``: ``"chip"``, ``"octets"`` or ``"stream"``.  ``segments``:
    ``(kind, t0, steps)`` in step order, one launcher call each: ``"chip"``
    the on-chip pair kernel over the whole call; ``"quads"`` the octet
    launcher over ``steps // 4`` quads and a tail of ``steps % 4`` (0 or 3)
    steps (octets, a lone quad, or the last quad and the tail as one 7-step
    launch); ``"pairs"`` the streaming pair kernel, one launch a pair;
    ``"steps"`` the step kernel, one launch a step.  The first segment takes
    the entry shift.  ``launches``: the kernel launches of the call, the
    entry minimum's pass included.  ``blocks``: blocks a frame of the
    on-chip form (0 in the others)."""
    form: str
    segments: tuple[tuple[str, int, int], ...]
    launches: int
    blocks: int = 0


def plan(code: CodeSpec, B: int, T: int) -> Plan:
    """The form of a ``B``-frame, ``T``-step call and its launches, on the
    shape alone: on chip where ``large_k2.chip_blocks`` gives blocks; else
    octets where ``large_k4.supports`` the code; else streaming.  Raises
    for a shape that no form takes."""
    from . import large_k2, large_k4  # both import this module
    if B > MAX_CALL_B:
        raise ValueError(f"acs_update_large: no form takes B={B}: at most {MAX_CALL_B} frames a "
                         "call (the kernels' grid y extent; the JAX package has no cap: split "
                         "the batch)")
    if not 7 <= code.K <= 24 or not 1 <= code.R <= 8 or not 1 <= B or T < 1:
        raise ValueError(f"acs_update_large: no form takes {code.name} (K={code.K}, "
                         f"R={code.R}) at B={B}, T={T}")
    blocks = large_k2.chip_blocks(code, B)
    if blocks:
        return Plan("chip", (("chip", 0, T),), 1, blocks)
    segments, launches = [], 1  # the entry minimum
    if large_k4.supports(code):
        nq, rest = divmod(T, 4)
        if rest == 3:  # the last quad (if any) and the 3 steps as one launch
            lq = max(nq - 1, 0)
            segments.append(("quads", 0, T))
            launches += lq // 2 + lq % 2 + 1
        else:
            if nq:
                segments.append(("quads", 0, 4 * nq))
                launches += nq // 2 + nq % 2
            if rest:
                segments.append(("pairs" if rest == 2 else "steps", 4 * nq, rest))
                launches += 1
        return Plan("octets", tuple(segments), launches)
    if code.K == 7:  # a pair block would hold fewer than a warp of threads
        return Plan("stream", (("steps", 0, T),), launches + T)
    if T >= 2:
        segments.append(("pairs", 0, 2 * (T // 2)))
        launches += T // 2
    if T % 2:
        segments.append(("steps", T - 1, 1))
        launches += 1
    return Plan("stream", tuple(segments), launches)


def plan_ref(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
             symbols: torch.Tensor, p: Plan | None = None):
    """``plan``'s segments on the plain ACS: the entry shift, then each
    segment's steps in order with no shift (pair and quad runs through
    ``large_k4._runs_ref`` at ``rn = 0``), checking that the segments tile
    the call.  Equal to ``acs_update_large_ref`` for a plan that is right."""
    from .large_k4 import _runs_ref
    _check_inputs(code, metrics, symbols, 7)
    B, T, _ = symbols.shape
    p = p or plan(code, B, T)
    symbols = symbols.to(torch.int32)
    m, offset = _shift_to_zero(metrics.to(torch.int32))
    blocks, t = [], 0
    for kind, t0, n in p.segments:
        if t0 != t or n < 1:
            raise ValueError(f"plan segments {p.segments} do not tile {T} steps")
        unit = {"quads": 4, "pairs": 2}.get(kind, 1)
        m, w, offset = _runs_ref(code, numeric, m, symbols[:, t0:t0 + n], offset, unit, 0)
        blocks.append(w)
        t += n
    if t != T:
        raise ValueError(f"plan segments {p.segments} do not tile {T} steps")
    return m, torch.cat(blocks, dim=1), offset.to(torch.int32)


def launch_large(counter: str, steps: int, code: CodeSpec, numeric: NumericSpec,
                 metrics: torch.Tensor, symbols: torch.Tensor, words: torch.Tensor,
                 offset: torch.Tensor, word_strides: tuple[int, int], t0: int, nl: int,
                 rn: int = 0, g2: torch.Tensor | None = None,
                 g2_strides: tuple[int, int] = (0, 0), shifts: bool = True,
                 entry: torch.Tensor | None = None, fresh: bool = False) -> torch.Tensor:
    """Check and call the streaming launcher of ``csrc/viterbi_large.cu``:
    ``nl`` launches of the pair (``steps=2``) or step (``steps=1``) kernel
    from step ``t0`` of ``symbols``, renormalising every ``rn`` launches.
    Returns the final metrics ``[B, S]`` int32; ``words`` and ``offset`` (and
    ``g2``, the pair kernel's optional G_2 planes) are filled in place (the
    offset accumulates; ``fresh``: the entry minimum's pass zeroes it first).
    ``entry``: a ``[B]`` row holding the entry shift, computed by an earlier
    launch (else a ``frame_min_kernel`` pass takes it).  ``shifts=False``
    (with ``rn = 0``): no entry shift either, for launches whose shifts a
    later one subsumes."""
    if not shifts and (rn or entry is not None):
        raise ValueError("launch_large: a renormalisation schedule or entry row needs shifts")
    nmins = (1 if shifts and entry is None else 0) + (nl // rn if rn else 0)
    m_out, scratch, _alive = launch_args(code, metrics, symbols, offset, nl, nmins)
    _build.launch(counter, "viterbi_acs_large", metrics.device, steps, *scratch[:5],
                  words.data_ptr(), g2.data_ptr() if g2 is not None else None, *scratch[5:],
                  entry.data_ptr() if entry is not None else None, int(fresh),
                  *code_args(code, numeric), *symbols.shape[:2], t0, nl, rn, *word_strides,
                  *g2_strides)
    return m_out


def launch_args(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor,
                offset: torch.Tensor, launches: int, nmins: int, fill: bool = False):
    """What the launchers of the state-blocked kernels share: the checks, the
    output metrics, a second buffer for ping-pong where there are two
    launches or more, and ``nmins`` rows ``[nmins, B]`` of pending shifts
    (none for 0), filled with INT32_MAX only with ``fill`` (rows that ACS
    kernels ``atomicMin`` into; ``frame_min_kernel`` writes its rows
    whole).  Returns ``(m_out, (m_in, symbols, polys, m_out, m_tmp | None,
    offset, mins | None, nmins), scratch tensors)``: the pointers as the
    launchers take them, and the tensors the caller keeps until it has
    launched."""
    B, T, R = symbols.shape
    _build.check_cuda_int32("metrics", metrics, (B, code.num_states))
    _build.check_cuda_int32("symbols", symbols, (B, T, R))
    _build.check_cuda_int32("offset", offset, (B,))
    m_out = torch.empty_like(metrics)
    m_tmp = torch.empty_like(metrics) if launches > 1 else None
    mins = None
    if nmins:
        mins = (torch.full((nmins, B), INT32_MAX, dtype=torch.int32, device=metrics.device)
                if fill else torch.empty((nmins, B), dtype=torch.int32, device=metrics.device))
    polys = (ctypes.c_int * R)(*code.abs_polys())

    def ptr(x):
        return x.data_ptr() if x is not None else None

    return m_out, (metrics.data_ptr(), symbols.data_ptr(), polys, m_out.data_ptr(),
                   ptr(m_tmp), offset.data_ptr(), ptr(mins), nmins), (m_tmp, mins)


def code_args(code: CodeSpec, numeric: NumericSpec) -> tuple[int, int, int, int, int]:
    """``(K, R, inv, low, high + low)`` of the launchers' signatures."""
    inv = sum(1 << r for r, i in enumerate(code.inversions()) if i)
    return code.K, code.R, inv, numeric.soft_low, numeric.soft_high + numeric.soft_low


def acs_update_large(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                     symbols: torch.Tensor):
    """ACS over a whole block with the entry shift only, in the form that
    ``plan`` picks (on chip, octets or streaming).

    Args:
      metrics: ``[B, S]`` int32.
      symbols: ``[B, T, R]`` int32, ``T >= 1``.

    Returns ``(metrics [B, S] int32, words [B, T, W] int32, offset [B]
    int32)``; ``offset`` is the block-entry shift (add it back for the true
    accumulated path error).
    """
    if not metrics.is_cuda:
        return acs_update_large_ref(code, numeric, metrics, symbols)
    from . import large_k2, large_k4  # both import this module
    _check_inputs(code, metrics, symbols, 7)
    B, T, _ = symbols.shape
    p = plan(code, B, T)
    W = code.decision_words
    words = torch.empty((B, T, W), dtype=torch.int32, device=metrics.device)
    offset = torch.empty((B,), dtype=torch.int32, device=metrics.device)
    strides = (T * W, W)
    m = metrics
    for i, (kind, t0, n) in enumerate(p.segments):
        first = i == 0  # takes the entry shift and writes the offset
        if kind == "chip":  # the only segment
            m = large_k2.launch_chip(code, numeric, m, symbols, words, offset, strides, t0, n, 0,
                                     p.blocks, counter="acs_update_large", fresh=True,
                                     tail_shift=False)
        elif kind == "quads":  # always the first segment
            m = large_k4.launch_quads("acs_update_large", large_k4.MODE_WORDS, code, numeric, m,
                                      symbols, words, offset, strides, t0, n // 4, 0, n % 4,
                                      fresh=True)
        else:
            steps = 2 if kind == "pairs" else 1
            m = launch_large("acs_update_large", steps, code, numeric, m, symbols, words, offset,
                             strides, t0, n // steps, shifts=first, fresh=first)
    return m, words, offset
