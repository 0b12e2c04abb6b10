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
length ``>= t_real``; words at steps ``>= t_real`` are undefined.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import pack_bits_to_words
from .. import acs, chainback
from ..branch import packed_transition_table
from . import _build

__all__ = ["acs_update_tb", "acs_update_tb_ref", "chainback_tb", "chainback_tb_ref",
           "acs_smem_bytes", "complement_form", "warp_lane_table", "launch_acs_tb"]

STAGE = 32     # symbol steps staged per shared-memory refill (kStage in the source)
TB_WARPS = 2   # warps a block of the K <= 9 warp form (kTbWarpThreads / 32)


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


def acs_update_tb_ref(code: CodeSpec, numeric: NumericSpec, metrics_sb: torch.Tensor,
                      symbols_trb: torch.Tensor, t_real: int):
    """Plain version of ``acs_update_tb`` (words past ``t_real`` are zero)."""
    S, B = metrics_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    m, words = _state_order_words(code, numeric, metrics_sb.T.to(torch.int32),
                                  symbols_trb[:t_real].permute(2, 0, 1))
    dec = torch.zeros((Tp, code.decision_words, B), dtype=torch.int32,
                      device=metrics_sb.device)
    dec[:t_real] = words.permute(1, 2, 0)
    return m.T.contiguous(), dec


def acs_update_tb(code: CodeSpec, numeric: NumericSpec, metrics_sb: torch.Tensor,
                  symbols_trb: torch.Tensor, t_real: int):
    """Whole-frame ACS in state order.

    Args:
      metrics_sb: ``[S, B]`` int32.
      symbols_trb: ``[Tp, R, B]`` int32, ``Tp >= t_real``.
      t_real: true number of trellis steps; later steps are never run.

    Returns ``(metrics [S, B] int32, dec_words [Tp, W, B] int32)``.
    """
    if not metrics_sb.is_cuda:
        return acs_update_tb_ref(code, numeric, metrics_sb, symbols_trb, t_real)
    return launch_acs_tb("acs_update_tb", 1, code, numeric, metrics_sb, symbols_trb, t_real)


def launch_acs_tb(counter: str, depth: int, code: CodeSpec, numeric: NumericSpec,
                  metrics_sb: torch.Tensor, symbols_trb: torch.Tensor, t_real: int):
    """Check and launch the state-order ACS at ``depth`` 1 or 2 (the warp
    form for K <= 9, whatever the depth)."""
    S, B = metrics_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    _build.check_cuda_int32("metrics_sb", metrics_sb, (code.num_states, B))
    _build.check_cuda_int32("symbols_trb", symbols_trb, (Tp, code.R, B))
    if code.K <= 9 and Tp * code.decision_words * B >= 1 << 32:
        raise ValueError(f"{counter}: the K <= 9 kernel indexes its words with 32 bits; "
                         f"Tp * W * B = {Tp * code.decision_words * B} does not fit")
    dev = metrics_sb.device
    m_out = torch.empty_like(metrics_sb)
    dec = torch.empty((Tp, code.decision_words, B), dtype=torch.int32, device=dev)
    _build.launch(
        counter, "viterbi_acs_tb" if depth == 1 else "viterbi_acs_tb2", dev,
        metrics_sb.data_ptr(), symbols_trb.data_ptr(), device_table(code, dev).data_ptr(),
        device_lane_table(code, dev).data_ptr(), m_out.data_ptr(), dec.data_ptr(), code.K,
        code.R, int(complement_form(code)), numeric.soft_low,
        numeric.soft_high + numeric.soft_low, B, t_real)
    return m_out, dec


def walk_ref(code: CodeSpec, dec_words: torch.Tensor, endstate: torch.Tensor, t_real: int,
             rotated: bool = False, p0: int = 0) -> torch.Tensor:
    """Plain reverse walk shared by both tracebacks: ``[ceil(Tp/32), B]``
    int32, bit ``t % 32`` of word ``t // 32`` = walk output at step ``t``
    (zero past ``t_real``).  ``rotated``: state ``s``'s decision at step
    ``t`` sits at position ``rotr(s, (t + 1 + p0) mod (K-1))``."""
    Tp, W, B = dec_words.shape
    t_real = _check_t_real(t_real, Tp)
    ks, _ = chainback.walk(code, dec_words[:t_real].permute(2, 0, 1), endstate.reshape(B),
                           rotated, p0)
    nw = -(-Tp // 32)
    return pack_bits_to_words(F.pad(ks, (0, 32 * nw - t_real))).T.contiguous()


def chainback_tb_ref(code: CodeSpec, dec_words: torch.Tensor, endstate: torch.Tensor,
                     t_real: int) -> torch.Tensor:
    """Plain version of ``chainback_tb``."""
    return walk_ref(code, dec_words, endstate, t_real)


def launch_chainback(counter: str, fn_name: str, code: CodeSpec, dec_words: torch.Tensor,
                     endstate: torch.Tensor, t_real: int, *extra) -> torch.Tensor:
    """Check and launch one of the two traceback kernels."""
    Tp, W, B = dec_words.shape
    t_real = _check_t_real(t_real, Tp)
    _build.check_cuda_int32("dec_words", dec_words, (Tp, code.decision_words, B))
    _build.check_cuda_int32("endstate", endstate, (1, B))
    nw = -(-Tp // 32)
    bits = torch.empty((nw, B), dtype=torch.int32, device=dec_words.device)
    _build.launch(counter, fn_name, dec_words.device, dec_words.data_ptr(),
                  endstate.data_ptr(), bits.data_ptr(), code.K, B, t_real, nw, *extra)
    return bits


def chainback_tb(code: CodeSpec, dec_words: torch.Tensor, endstate: torch.Tensor,
                 t_real: int) -> torch.Tensor:
    """Traceback over state-order words.

    Args:
      dec_words: ``[Tp, W, B]`` int32 from ``acs_update_tb``.
      endstate: ``[1, B]`` int32 survivor state at step ``t_real``.
      t_real: the walk starts at step ``t_real - 1``.

    Returns packed trellis bits ``[ceil(Tp/32), B]`` int32 -- bit ``t % 32``
    of word ``t // 32`` is the walk output at step t (data bit ``t - K + 1``).
    """
    if not dec_words.is_cuda:
        return chainback_tb_ref(code, dec_words, endstate, t_real)
    return launch_chainback("chainback_tb", "viterbi_chainback_tb", code, dec_words,
                            endstate, t_real)
