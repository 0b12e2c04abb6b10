"""State-order whole-frame kernels: ACS update and traceback.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py``
(``acs_update_tb``, ``chainback_tb``).  The CUDA kernels are
``acs_tb_warp_kernel`` (K <= 9; a warp a frame, metrics in registers in state
order, predecessors by shuffles from the source lanes of
``warp_lane_table``), ``acs_tb_block_kernel`` (K = 10..15, which no route
sends here) and ``chainback_kernel<false>`` in ``csrc/viterbi_small.cu``;
beside each wrapper is its plain PyTorch version (``*_ref``) with the same
contract.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

Layout is the Pallas kernels' state-major one: metrics ``[S, B]``, symbols
``[Tp, R, B]``, decision words ``[Tp, W, B]`` (int32 holding uint32 bits,
bit ``s % 32`` of word ``s // 32`` for new state ``s``).  ``Tp`` may be any
length ``>= t_real``; words at steps ``>= t_real`` are undefined.  The ACS
kernels read metrics and symbols of any strides (``acs_launch_args`` passes
each tensor's ``stride()``): a batch-major caller hands them
``symbols.permute(1, 2, 0)`` of its ``[B, T, R]`` and ``metrics.T`` of its
``[B, S]``, and gets the exit metrics in the entry metrics' layout
(``metrics_like``).  Words are written contiguous.

The traceback kernel writes its output in one of ``FORMS`` itself -- the
Pallas layout's packed words, a byte a step for a range of steps, or data
bytes MSB-first -- and takes its end state from an int, a tensor, or the
argmin of the frame's metrics; a frame may start its walk from state 0 at a
step of its own.  So a decoder's traceback, a stream's release and a time
block's walk are one launch each (``chainback_tb``'s docstring).  At K <= 9
it walks a frame's time as ``walk_plan``'s segments, each from a guessed
state above its top, and walks again the segments whose guess did not meet
the segment above: the outputs are the serial walk's, bit for bit
(``rewalk_stats`` counts how often a segment is walked again).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import bits_to_bytes, pack_bits_to_words
from .. import acs, chainback
from ..branch import packed_transition_table
from . import _build
from .walk import _end_args

__all__ = ["acs_update_tb", "acs_update_tb_ref", "chainback_tb", "chainback_tb_ref",
           "acs_smem_bytes", "complement_form", "warp_lane_table", "launch_acs_tb",
           "acs_launch_args", "check_acs_inputs", "metrics_like", "argmin_states", "FORMS",
           "walk_plan", "rewalk_stats", "WALK_CHAINS", "WALK_MAX_SEGMENTS"]

STAGE = 32     # symbol steps staged per shared-memory refill (kStage in the source)
TB_WARPS = 2   # warps a block of the K <= 9 warp form (kTbWarpThreads / 32)
TB_MAX_K = 24  # chainback_tb's largest trellis: 2^18 words a step
FORMS = ("words", "bits", "bytes")  # the tracebacks' output forms (CbOut in the source)
_END_ARGMIN = 3  # the end-state kind that takes the argmin of the metrics (CbEnd)
WALK_CHAINS = 132 * 4 * 32  # a warp of chains on each of an H100's 528 SM sub-partitions
WALK_MAX_SEGMENTS = 64      # a block holds 8 frames with all their segments: 512 threads (kSegMax)


@functools.lru_cache(maxsize=None)
def complement_form(code: CodeSpec) -> bool:
    """Whether every butterfly uses one pattern and its complement: the
    branches ``(h, b)`` = (0, 1) and (1, 0) carry the complement of (0, 0)'s
    pattern and (1, 1) carries the same.  True when every polynomial taps both
    ends of the register (all six reference codes); the kernels then take the
    penalty of a pattern's complement as ``R * (high - low)`` minus its own."""
    e = packed_transition_table(code).astype(np.int64)
    full = (1 << code.R) - 1
    x = [(e >> (8 * k)) & 0xFF for k in range(4)]
    return bool(((x[1] == (x[0] ^ full)) & (x[2] == (x[0] ^ full)) & (x[3] == x[0])).all())


@functools.lru_cache(maxsize=None)
def warp_lane_table(code: CodeSpec) -> np.ndarray:
    """``[max(S, 32)]`` int32, the K <= 9 warp form's per-(lane, register)
    constants, entry ``n = 32*r + lane`` for new state ``n`` (zero past
    ``S``): byte 0 the penalty pattern of the branch from its low predecessor
    ``n >> 1`` (``h = 0``, input bit ``b = n & 1``), byte 1 that of the
    branch from its high predecessor ``(n >> 1) + S/2``, bytes 2 and 3 the
    lanes that hold those two predecessors.  The registers that hold them are
    compile-time in the kernel: ``r >> 1`` and ``(r >> 1) + NR/2`` for
    register ``r`` of ``NR = S/32``, register 0 for both below 64 states."""
    S = code.num_states
    n = np.arange(S, dtype=np.int64)
    e = packed_transition_table(code).astype(np.int64)[n >> 1]
    b = n & 1
    lo_pat = (e >> (8 * b)) & 0xFF
    hi_pat = (e >> (8 * (2 + b))) & 0xFF
    lo_lane = (n >> 1) % 32
    hi_lane = ((n >> 1) + S // 2) % 32
    out = np.zeros(max(S, 32), dtype=np.int64)
    out[:S] = lo_pat | (hi_pat << 8) | (lo_lane << 16) | (hi_lane << 24)
    return out.astype(np.uint32).view(np.int32)


def acs_smem_bytes(code: CodeSpec, depth: int = 1) -> int:
    """Dynamic shared memory of one block of the state-order ACS launch, as
    the launcher in the source computes it (``tb_smem``).  K <= 9 (the warp
    form, either depth): for each of its two warps, two penalty tables of
    ``2^R`` columns of 33 words (32 steps) and two stages of symbols.  K >= 10, depth 1:
    two metric buffers, the packed transition table, the staged symbols and
    two steps of decision bytes; depth 2: two metric buffers and the staged
    symbols."""
    S, W, R = code.num_states, code.decision_words, code.R
    if code.K <= 9:
        return TB_WARPS * 4 * (2 * (1 << R) * (STAGE + 1) + 2 * 32 * R)
    if depth == 2:
        return 4 * (2 * S + STAGE * R)
    return 4 * (2 * S + S // 2 + STAGE * R) + 2 * W * 32


@functools.lru_cache(maxsize=None)
def device_table(code: CodeSpec, device: torch.device) -> torch.Tensor:
    """``packed_transition_table(code)`` on ``device``, uploaded once per code
    and device: an upload from pageable host memory at every launch would make
    the host wait for the stream between the links of a chain."""
    return torch.as_tensor(packed_transition_table(code), device=device)


@functools.lru_cache(maxsize=None)
def device_lane_table(code: CodeSpec, device: torch.device) -> torch.Tensor:
    """``warp_lane_table(code)`` on ``device``, uploaded once."""
    return torch.as_tensor(warp_lane_table(code), device=device)


def _check_t_real(t_real: int, Tp: int) -> int:
    t_real = int(t_real)
    if not (0 < t_real <= Tp):
        raise ValueError(f"t_real={t_real} outside (0, {Tp}]")
    return t_real


def _state_order_words(code: CodeSpec, numeric: NumericSpec, m_bs: torch.Tensor,
                       sym_btr: torch.Tensor):
    """State-order ACS over ``sym_btr [B, t, R]`` with no renormalisation
    (the kernels never renormalise): ``(metrics [B, S], words [B, t, W])``."""
    plain = dataclasses.replace(numeric, renorm_interval=0)
    m, words, _ = acs.acs_update(code, plain, m_bs, sym_btr, fused_penalties=True)
    return m, words


def metrics_like(metrics_sb: torch.Tensor) -> torch.Tensor:
    """The exit metrics tensor of an ACS call: ``torch.empty_like`` the entry
    metrics, which keeps their strides where they are dense (``m.T`` of a
    ``[B, S]`` gives ``n.T`` of a new ``[B, S]``), else contiguous ``[S,
    B]``.  The kernels write through its strides, the plain versions copy
    into it."""
    return torch.empty_like(metrics_sb, dtype=torch.int32)


def acs_update_tb_ref(code: CodeSpec, numeric: NumericSpec, metrics_sb: torch.Tensor,
                      symbols_trb: torch.Tensor, t_real: int, out: torch.Tensor | None = None):
    """Plain version of ``acs_update_tb`` (words past ``t_real`` are zero;
    inputs of any strides, exit metrics in ``metrics_like``)."""
    S, B = metrics_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    m, words = _state_order_words(code, numeric, metrics_sb.T.to(torch.int32),
                                  symbols_trb[:t_real].permute(2, 0, 1))
    dec = torch.zeros((Tp, code.decision_words, B), dtype=torch.int32,
                      device=metrics_sb.device)
    dec[:t_real] = words.permute(1, 2, 0)
    return metrics_like(metrics_sb).copy_(m.T), _into(out, dec)


def acs_update_tb(code: CodeSpec, numeric: NumericSpec, metrics_sb: torch.Tensor,
                  symbols_trb: torch.Tensor, t_real: int, out: torch.Tensor | None = None):
    """Whole-frame ACS in state order.

    Args:
      metrics_sb: ``[S, B]`` int32 of any strides (``m.T`` of a ``[B, S]``).
      symbols_trb: ``[Tp, R, B]`` int32 of any strides, ``Tp >= t_real``
        (``s.permute(1, 2, 0)`` of a batch-major ``[B, T, R]``).
      t_real: true number of trellis steps; later steps are never run.
      out: where the words go, or None for a new tensor: a contiguous
        ``[Tp, W, B]`` int32 view (rows of a stream's window).

    Returns ``(metrics [S, B] int32 in the layout of metrics_like(metrics_sb),
    dec_words [Tp, W, B] int32)``.
    """
    if not metrics_sb.is_cuda:
        return acs_update_tb_ref(code, numeric, metrics_sb, symbols_trb, t_real, out)
    return launch_acs_tb("acs_update_tb", 1, code, numeric, metrics_sb, symbols_trb, t_real, out)


def _into(out: torch.Tensor | None, dec: torch.Tensor) -> torch.Tensor:
    """The plain versions' words, copied into ``out`` where one is given."""
    if out is None:
        return dec
    return out.copy_(dec)


def words_out(out: torch.Tensor | None, code: CodeSpec, Tp: int, B: int,
              device: torch.device) -> torch.Tensor:
    """The ``[Tp, W, B]`` int32 words tensor an ACS kernel writes: ``out``,
    checked, or a new one."""
    if out is None:
        return torch.empty((Tp, code.decision_words, B), dtype=torch.int32, device=device)
    _build.check_cuda_int32("out", out, (Tp, code.decision_words, B))
    if out.device != device:
        raise ValueError(f"out: expected a tensor on {device}, got {out.device}")
    return out


def check_acs_inputs(code: CodeSpec, metrics_sb: torch.Tensor, symbols_trb: torch.Tensor,
                     t_real: int) -> int:
    """Refuse what the whole-frame ACS kernels cannot take, by name: a tensor
    off the card, not int32, or of another shape than ``[S, B]`` and ``[Tp,
    R, B]`` (any strides pass; there is no copy to fall back on), a
    ``t_real`` outside ``(0, Tp]``, or more words than the K <= 9 kernels
    index with 32 bits.  Returns ``t_real``."""
    B = metrics_sb.shape[-1]
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    _build.check_cuda_int32("metrics_sb", metrics_sb, (code.num_states, B), contiguous=False)
    _build.check_cuda_int32("symbols_trb", symbols_trb, (Tp, code.R, B), contiguous=False)
    if symbols_trb.device != metrics_sb.device:
        raise ValueError(f"symbols_trb: expected a tensor on {metrics_sb.device}, got "
                         f"{symbols_trb.device}")
    if code.K <= 9 and Tp * code.decision_words * B >= 1 << 32:
        raise ValueError(f"{code.name}: the K <= 9 kernels index their words with 32 bits; "
                         f"Tp * W * B = {Tp * code.decision_words * B} does not fit")
    return t_real


def acs_launch_args(metrics_sb: torch.Tensor, symbols_trb: torch.Tensor, tables: tuple,
                    m_out: torch.Tensor, dec: torch.Tensor, scalars: tuple) -> tuple:
    """The arguments of a whole-frame ACS launcher (``viterbi_acs_tb``,
    ``viterbi_acs_tb2``, ``viterbi_acs_inplace``), in their order: entry
    metrics and their element strides ``(s, b)``, symbols and theirs ``(t,
    r, b)``, the device tables, exit metrics and their strides, the words,
    then ``scalars``.  Element ``(s, b)`` of the metrics is read at ``s *
    ms + b * mb`` words from the pointer, and so on: each tensor's own
    ``stride()``."""
    return (metrics_sb.data_ptr(), *metrics_sb.stride(), symbols_trb.data_ptr(),
            *symbols_trb.stride(), *(t.data_ptr() for t in tables), m_out.data_ptr(),
            *m_out.stride(), dec.data_ptr(), *scalars)


def launch_acs_tb(counter: str, depth: int, code: CodeSpec, numeric: NumericSpec,
                  metrics_sb: torch.Tensor, symbols_trb: torch.Tensor, t_real: int,
                  out: torch.Tensor | None = None):
    """Check and launch the state-order ACS at ``depth`` 1 or 2 (the warp
    form for K <= 9, whatever the depth) on metrics and symbols of any
    strides, its words into ``out`` where one is given."""
    t_real = check_acs_inputs(code, metrics_sb, symbols_trb, t_real)
    B, Tp = metrics_sb.shape[1], symbols_trb.shape[0]
    dev = metrics_sb.device
    m_out = metrics_like(metrics_sb)
    dec = words_out(out, code, Tp, B, dev)
    _build.launch(
        counter, "viterbi_acs_tb" if depth == 1 else "viterbi_acs_tb2", dev,
        *acs_launch_args(metrics_sb, symbols_trb,
                         (device_table(code, dev), device_lane_table(code, dev)), m_out, dec,
                         (code.K, code.R, int(complement_form(code)), numeric.soft_low,
                          numeric.soft_high + numeric.soft_low, B, t_real)))
    return m_out, dec


def _end_states(code: CodeSpec, endstate, batch: int, device: torch.device) -> torch.Tensor:
    """``endstate`` (an int, or a 0-d, ``[B]`` or ``[1, B]`` tensor) as the
    ``[1, B]`` int32 tensor the plain walks read.  A tensor stays on its
    device: nothing here waits for the stream."""
    mask = code.num_states - 1
    if isinstance(endstate, torch.Tensor):
        end = endstate.to(device=device, dtype=torch.int32) & mask
        return end.reshape(1, -1).expand(1, batch).contiguous()
    return torch.full((1, batch), int(endstate) & mask, dtype=torch.int32, device=device)


def _check_form(form: str, lo: int, hi: int, t_real: int) -> None:
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    if form != "words" and not (0 <= lo <= hi <= t_real):
        raise ValueError(f"outputs [{lo}, {hi}) outside the walk's {t_real} steps")
    if form == "bytes" and (hi - lo) % 8:
        raise ValueError(f"bit count {hi - lo} not a multiple of 8")


def _form_shape(form: str, B: int, Tp: int, lo: int, hi: int) -> tuple:
    if form == "words":
        return (-(-Tp // 32), B)
    return (B, hi - lo) if form == "bits" else (B, (hi - lo) // 8)


def argmin_states(code: CodeSpec, metrics: torch.Tensor, phase: int = 0) -> torch.Tensor:
    """``[B]`` int32: the first state of least metric of each frame, from
    ``metrics [S, B]`` (any strides) held in position space of rotation
    phase ``phase`` (state ``s`` at position ``rotr(s, phase)``; 0: state
    order)."""
    nrot, S = code.K - 1, code.num_states
    c = phase % nrot
    if c:
        s = torch.arange(S, device=metrics.device)
        metrics = metrics[((s >> c) | (s << (nrot - c))) & (S - 1)]
    return torch.argmin(metrics, dim=0).to(torch.int32)


def walk_ref(code: CodeSpec, dec_words: torch.Tensor, endstate, t_real: int,
             rotated: bool = False, p0: int = 0, form: str = "words", lo: int = 0,
             hi: int | None = None, out: torch.Tensor | None = None,
             start: torch.Tensor | None = None, metrics: torch.Tensor | None = None,
             metrics_phase: int = 0) -> torch.Tensor:
    """Plain reverse walk shared by both tracebacks, in each output form
    (``chainback_tb``'s contract).  ``rotated``: state ``s``'s decision at
    step ``t`` sits at position ``rotr(s, (t + 1 + p0) mod (K-1))``.  A
    frame's start step is its words zeroed from that step on and its end
    state 0 (a zero word is "every decision 0" in either packing)."""
    Tp, W, B = dec_words.shape
    t_real = _check_t_real(t_real, Tp)
    hi = t_real if hi is None else int(hi)
    _check_form(form, lo, hi, t_real)
    dev = dec_words.device
    if metrics is not None:
        end = argmin_states(code, metrics.to(dev), metrics_phase)
    else:
        end = _end_states(code, endstate, B, dev).reshape(B)
    words = dec_words[:t_real]
    if start is not None:
        first = start.to(device=dev, dtype=torch.int64).reshape(B)
        live = torch.arange(t_real, device=dev)[:, None] < first
        words = torch.where(live[:, None, :], words, torch.zeros((), dtype=words.dtype, device=dev))
        end = torch.where(first < t_real, torch.zeros_like(end), end)
    ks, _ = chainback.walk(code, words.permute(2, 0, 1), end, rotated, p0)
    res = walk_outputs(ks, form, lo, hi, Tp)
    if out is None:
        return res
    out.copy_(res)
    return out


def walk_outputs(ks: torch.Tensor, form: str, lo: int, hi: int, Tp: int) -> torch.Tensor:
    """The walk outputs ``ks [B, t_real]`` (0 or 1) in the output form
    ``form`` of a walk over ``Tp`` steps of words."""
    if form == "words":
        return pack_bits_to_words(F.pad(ks, (0, 32 * -(-Tp // 32) - ks.shape[1]))).T.contiguous()
    res = ks[:, lo:hi].to(torch.uint8)
    return bits_to_bytes(res) if form == "bytes" else res


@functools.lru_cache(maxsize=1024)
def walk_plan(K: int, B: int, T: int) -> tuple[int, int, int]:
    """The staged walk's segments (K <= 9) for ``B`` frames of ``T`` steps:
    ``(n, L, D)``, n segments of L steps (a multiple of 32; the last one
    ends at T), each walked from a guessed state D steps above its top.

    n is the least for which ``B * n`` chains reach ``WALK_CHAINS``, at
    most ``WALK_MAX_SEGMENTS``; 1 (the serial walk, no overlap) where B
    alone reaches it or ``T <= L + D``.  D, about ten constraint lengths
    in whole chunks (64 steps at K=7), is where the survivors have merged
    but for a small share of segments, which are walked again."""
    D = 32 * -(-10 * (K - 1) // 32)
    whole = 32 * -(-T // 32)
    want = -(-WALK_CHAINS // B)
    if want <= 1:
        return 1, whole, D
    L = max(32, (T - 1) // (want - 1) // 32 * 32)  # the longest L with ceil(T / L) >= want
    if -(-T // L) > WALK_MAX_SEGMENTS:
        L = 32 * -(-T // (32 * WALK_MAX_SEGMENTS))
    if T <= L + D:
        return 1, whole, D
    return -(-T // L), L, D


_REWALKS: dict[torch.device, torch.Tensor] = {}  # the kernel's count of segments walked again


def _rewalk_counter(dev: torch.device) -> torch.Tensor | None:
    """The device's int64 count of segments walked again, made (zero) at its
    first walk; None while a CUDA graph is being captured before then (the
    walk then counts nothing)."""
    counter = _REWALKS.get(dev)
    if counter is None:
        if torch.cuda.is_current_stream_capturing():
            return None
        counter = _REWALKS[dev] = torch.zeros((), dtype=torch.int64, device=dev)
    return counter


def rewalk_stats() -> dict[str, int]:
    """``{"segments": n, "rewalked": m}``: the staged walk's segments
    launched (``_build.WALK_SEGMENTS``, counted from each launch's plan) and
    walked again (the kernel's count on every device) since the process
    started.  Waits for the devices; tests and probes call it, never the
    decoders."""
    return {"segments": _build.WALK_SEGMENTS["launched"],
            "rewalked": sum(int(c.item()) for c in _REWALKS.values())}


def chainback_tb_ref(code: CodeSpec, dec_words: torch.Tensor, endstate, t_real: int,
                     form: str = "words", lo: int = 0, hi: int | None = None, *,
                     out: torch.Tensor | None = None, start: torch.Tensor | None = None,
                     metrics: torch.Tensor | None = None, metrics_phase: int = 0) -> torch.Tensor:
    """Plain version of ``chainback_tb``."""
    return walk_ref(code, dec_words, endstate, t_real, False, 0, form, lo, hi, out, start,
                    metrics, metrics_phase)


def launch_chainback(counter: str, rot: bool, code: CodeSpec, dec_words: torch.Tensor, endstate,
                     t_real: int, max_k: int, p0: int = 0, form: str = "words", lo: int = 0,
                     hi: int | None = None, out: torch.Tensor | None = None,
                     start: torch.Tensor | None = None, metrics: torch.Tensor | None = None,
                     metrics_phase: int = 0) -> torch.Tensor:
    """Check and launch one of the two traceback kernels over ``dec_words``
    of any strides, in the output form ``form``, from the end state that
    ``endstate`` or ``metrics`` gives."""
    Tp, W, B = dec_words.shape
    t_real = _check_t_real(t_real, Tp)
    hi = t_real if hi is None else int(hi)
    _check_form(form, lo, hi, t_real)
    if code.K > max_k:
        raise ValueError(f"{counter}: K <= {max_k}, got K={code.K}")
    if not dec_words.is_cuda or dec_words.dtype != torch.int32 or W != code.decision_words:
        raise ValueError(f"dec_words: expected CUDA int32 [Tp, {code.decision_words}, B], got "
                         f"{dec_words.device} {dec_words.dtype} {tuple(dec_words.shape)}")
    dev = dec_words.device
    if metrics is not None:
        if (metrics.device != dev or metrics.dtype != torch.int32
                or tuple(metrics.shape) != (code.num_states, B)):
            raise ValueError(f"metrics: expected {dev} int32 [{code.num_states}, {B}] (any "
                             f"strides), got {metrics.device} {metrics.dtype} "
                             f"{tuple(metrics.shape)}")
        end_ptr, end_kind, end_stride, end_value = None, _END_ARGMIN, 0, 0
    else:
        end_ptr, end_kind, end_stride, end_value, _keep = _end_args(endstate, B, dev)
    if start is not None:
        _build.check_cuda_int32("start", start, (B,))
    shape = _form_shape(form, B, Tp, lo, hi)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32 if form == "words" else torch.uint8, device=dev)
    elif (form == "words" or out.device != dev or out.dtype != torch.uint8
          or tuple(out.shape) != shape or (shape[1] > 1 and out.stride(1) != 1)):
        raise ValueError(f"out: expected a {dev} uint8 {list(shape)} tensor with unit column "
                         f"stride for the {form} form, got {out.device} {out.dtype} "
                         f"{tuple(out.shape)}")
    # The walk keeps a chunk's outputs as a word in every form: the bits and
    # bytes forms give it a scratch to keep them in.
    scratch = (torch.empty((-(-t_real // 32), B), dtype=torch.int32, device=dev)
               if form != "words" else None)
    plan, rewalks = (1, 32, 0), None
    if code.decision_words <= 8:  # the staged form, in segments
        plan, rewalks = walk_plan(code.K, B, t_real), _rewalk_counter(dev)
        _build.WALK_SEGMENTS["launched"] += B * plan[0]
    _build.launch(counter, "viterbi_chainback", dev, int(rot), dec_words.data_ptr(),
                  *dec_words.stride(), end_kind, end_value, end_ptr, end_stride,
                  None if metrics is None else metrics.data_ptr(),
                  *(metrics.stride() if metrics is not None else (0, 0)),
                  metrics_phase % (code.K - 1), None if start is None else start.data_ptr(),
                  FORMS.index(form), out.data_ptr(), out.stride(0) if form != "words" else 0,
                  None if scratch is None else scratch.data_ptr(), lo, hi, code.K, B, t_real,
                  shape[0] if form == "words" else 0, p0, *plan,
                  None if rewalks is None else rewalks.data_ptr())
    key = f"{counter}:{form}" + (":argmin" if metrics is not None else "")
    _build.FORM_LAUNCHES[key] = _build.FORM_LAUNCHES.get(key, 0) + 1
    return out


def chainback_tb(code: CodeSpec, dec_words: torch.Tensor, endstate, t_real: int,
                 form: str = "words", lo: int = 0, hi: int | None = None, *,
                 out: torch.Tensor | None = None, start: torch.Tensor | None = None,
                 metrics: torch.Tensor | None = None, metrics_phase: int = 0) -> torch.Tensor:
    """Traceback over state-order (canonical) words, K <= ``TB_MAX_K``.

    Args:
      dec_words: ``[Tp, W, B]`` int32 of any strides: from ``acs_update_tb``,
        or above K=15 the batch-major words ``[B, T, W]`` of the large-K
        updates as ``words.permute(1, 2, 0)``, walked where they lie.
      endstate: survivor state at step ``t_real``: an int, or a 0-d, ``[B]``
        or ``[1, B]`` int32 or uint8 device tensor, read where it lies.
      t_real: the walk starts at step ``t_real - 1``.
      form: ``"words"``: packed trellis bits ``[ceil(Tp/32), B]`` int32, bit
        ``t % 32`` of word ``t // 32`` the walk output at step t (data bit
        ``t - K + 1``); ``"bits"``: the outputs of steps ``[lo, hi)`` as
        uint8 ``[B, hi - lo]``; ``"bytes"``: the same packed MSB-first,
        ``[B, (hi - lo) // 8]`` (``lo = K-1``: the data bytes).
      hi: defaults to ``t_real``.
      out: where the bits or bytes go: a uint8 tensor of that shape with
        unit column stride and any row stride (a view of a larger tensor).
      start: ``[B]`` int32 on the device, or None: where ``start[b] <
        t_real``, frame b's walk starts from state 0 at step ``start[b]``
        and its outputs above are 0 -- the walk of its words zeroed from
        that step on.
      metrics: ``[S, B]`` int32 (any strides: ``m.T`` of a batch-major
        ``[B, S]``), or None: the end state is each frame's first state of
        least metric (``torch.argmin``), taken by the kernel; ``endstate``
        is then unused.  ``metrics_phase``: the metrics are in position
        space of that rotation phase (0: state order).

    The kernel writes every form itself; a CPU tensor takes the plain
    version (``chainback_tb_ref``).
    """
    if not dec_words.is_cuda:
        return chainback_tb_ref(code, dec_words, endstate, t_real, form, lo, hi, out=out,
                                start=start, metrics=metrics, metrics_phase=metrics_phase)
    return launch_chainback("chainback_tb", False, code, dec_words, endstate, t_real, TB_MAX_K,
                            0, form, lo, hi, out, start, metrics, metrics_phase)
