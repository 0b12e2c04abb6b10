"""Depth-2 fused state-blocked ACS for large trellises.

Port of ``acs_update_large2`` from
``ka9q_viterbi_comparison_tpu/ops/pallas/large_k2.py``.  The CUDA kernels are
in ``csrc/viterbi_large.cu``; each step pair runs in a thread's registers.
Where a frame's metrics fit on chip (``chip_blocks``: K <= 17) one launch of
``acs_pairs_chip_kernel`` runs the whole block, odd tail included, with each
frame's metrics in the shared memory of a cluster of 1-4 blocks (by the
trellis and the batch).  Larger trellises (K=24), and small ones whose blocks
have fewer threads than a pair has table entries, stream:
``acs_large_pair_kernel``, one launch a pair with the metrics in device
memory, the launch loop inside the C launcher, and an odd step count ends in
one launch of the step kernel (counted as ``acs_update_large``), as in the JAX
package.  The choice is
made on the shape alone.  Beside the wrapper is its
plain PyTorch version (``acs_update_large2_ref``) with the same contract.  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

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

import ctypes

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import pack_bits_to_words, unpack_words_to_bits
from . import _build
from .kernels import _state_order_words
from .large_k import (_check_inputs, _shift_to_zero, acs_update_large_ref, code_args,
                      launch_large, metric_dtype_for)

__all__ = ["acs_update_large2", "acs_update_large2_ref", "renorm_schedule", "launch_block",
           "chip_blocks"]

DTYPES = {"int16": torch.int16, "int32": torch.int32}
CHIP_STATES = 16384   # most states a block of the on-chip form holds (two 64 KB buffers)
CHIP_THREADS = 1024   # threads a block of the on-chip form, at most: one quad each
CHIP_WAVE = 128       # on-chip blocks the H100 runs at once: its 132 SMs in clusters of up to four


def chip_blocks(code: CodeSpec, batch: int) -> int:
    """Blocks a frame (one thread-block cluster) of the on-chip pair kernel
    for ``batch`` frames, or 0 where the block streams: where a frame's
    metrics do not fit on chip (``S / 4 > CHIP_STATES``), and where a block
    has fewer threads than a pair has table entries (``2^(R+1)``; K=8-11
    with R >= 5).  Where one block gives each thread one quad at most
    (``S <= 4 * CHIP_THREADS``), one block; above, the most blocks (each at
    most ``CHIP_STATES`` states) that run every frame in one wave
    (``batch * blocks <= CHIP_WAVE``), else the fewest.  Measured at K=11-16
    (``harness/probe_large.py``, PERF.md): a cluster costs a fixed 1.5 us a
    pair, paid back from K=14 while one wave holds every frame.  The
    launcher takes the count and checks it."""
    S = code.num_states
    if not 8 <= code.K <= 24 or S // 4 > CHIP_STATES:
        return 0
    if S <= 4 * CHIP_THREADS:
        return 1 if S // 4 >= 2 << code.R else 0
    fits = [cl for cl in (1, 2, 4) if S // cl <= CHIP_STATES]
    wave = [cl for cl in fits if batch * cl <= CHIP_WAVE]
    return max(wave) if wave else fits[0]


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
                 g2: torch.Tensor | None = None, g2_strides: tuple[int, int] = (0, 0),
                 shifts: bool = True, entry: torch.Tensor | None = None):
    """Steps ``[t0, t0 + T)`` of ``symbols`` as one ``acs_update_large2``
    block on the card, on the schedule of a ``T``-step block: where the frame
    fits on chip, one launch of the on-chip kernel; else ``T // 2`` launches
    of the streaming pair kernel, then the odd tail as one launch of the step
    kernel with its own entry shift.  Returns the metrics; ``words``,
    ``offset`` and ``g2`` are filled in place.

    The ACS commutes with a uniform shift and the metrics are int32, so the
    shifts up to a point add up to the frame minimum there: a shift that a
    later one follows changes neither the returned metrics nor the offset.
    With ``shifts=False`` (a block inside a call whose entry shift was taken,
    and whose caller shifts next) the streaming form skips every shift, each
    a pass over the metrics.  The entry shift of a block with ``shifts`` is
    always taken, so that entry metrics near the int32 limit cannot wrap.
    ``entry`` (streaming only): a ``[B]`` row holding the block's entry
    shift, the frame minimum that the launch before took, so that the first
    launch makes no pass of its own for it."""
    _, rn = renorm_schedule(code, numeric, T, metric_dtype)
    blocks = chip_blocks(code, metrics.shape[0])
    if blocks:
        return launch_chip(code, numeric, metrics, symbols, words, offset, strides, t0, T, rn,
                           blocks, g2, g2_strides)
    m = metrics
    if T >= 2:
        m = launch_large("acs_update_large2", 2, code, numeric, m, symbols, words, offset,
                         strides, t0, T // 2, rn if shifts else 0, g2, g2_strides, shifts, entry)
        entry = None
    if T % 2:
        m = launch_large("acs_update_large", 1, code, numeric, m, symbols, words, offset,
                         strides, t0 + T - 1, 1, shifts=shifts, entry=entry)
    return m


def launch_chip(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                symbols: torch.Tensor, words: torch.Tensor, offset: torch.Tensor,
                strides: tuple[int, int], t0: int, T: int, rn: int, blocks: int,
                g2: torch.Tensor | None = None, g2_strides: tuple[int, int] = (0, 0),
                counter: str = "acs_update_large2", fresh: bool = False,
                tail_shift: bool = True):
    """Check and call the on-chip launcher of ``csrc/viterbi_large.cu``: one
    launch for steps ``[t0, t0 + T)``, ``blocks`` blocks a frame (1, 2 or
    4), renormalising after every ``rn``-th pair; an odd ``T``'s last step
    takes its own entry shift unless ``tail_shift`` is off (as in
    ``acs_update_large``).  ``offset`` accumulates the shifts (``fresh``: is
    set to them).  Returns the final metrics ``[B, S]`` int32."""
    B, T_sym, R = symbols.shape
    _build.check_cuda_int32("metrics", metrics, (B, code.num_states))
    _build.check_cuda_int32("symbols", symbols, (B, T_sym, R))
    _build.check_cuda_int32("offset", offset, (B,))
    m_out = torch.empty_like(metrics)
    polys = (ctypes.c_int * R)(*code.abs_polys())
    _build.launch(counter, "viterbi_acs_large2_chip", metrics.device,
                  metrics.data_ptr(), symbols.data_ptr(), polys, m_out.data_ptr(),
                  words.data_ptr(), g2.data_ptr() if g2 is not None else None, offset.data_ptr(),
                  blocks, *code_args(code, numeric), B, T_sym, t0, T, rn, int(fresh),
                  int(tail_shift), *strides, *g2_strides)
    return m_out


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
