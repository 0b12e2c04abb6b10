"""State-order whole-frame kernels: ACS update and traceback.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py``
(``acs_update_tb``, ``chainback_tb``).  The CUDA kernels are
``acs_tb_kernel`` and ``chainback_kernel<false>`` in
``csrc/viterbi_small.cu``; beside each wrapper is its plain PyTorch version
(``*_ref``) with the same contract.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.

Layout is the Pallas kernels' state-major one: metrics ``[S, B]``, symbols
``[Tp, R, B]``, decision words ``[Tp, W, B]`` (int32 holding uint32 bits,
bit ``s % 32`` of word ``s // 32`` for new state ``s``).  ``Tp`` may be any
length ``>= t_real``; words at steps ``>= t_real`` are undefined.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import pack_bits_to_words
from .. import acs, chainback
from ..branch import packed_transition_table
from . import _build

__all__ = ["acs_update_tb", "acs_update_tb_ref", "chainback_tb", "chainback_tb_ref",
           "acs_smem_bytes"]

STAGE = 32  # symbol steps staged per shared-memory refill (kStage in the source)


def acs_smem_bytes(code: CodeSpec) -> int:
    """Dynamic shared memory of one ``acs_tb_kernel`` block (the carve-up of
    ``carve`` in the source): two metric buffers, the packed transition
    table, the staged symbols and two steps of decision bytes.  The in-place
    kernel's is ``inplace.inplace_smem_bytes``."""
    S = code.num_states
    W = code.decision_words
    return 4 * (2 * S + S // 2 + STAGE * code.R) + 2 * W * 32


@functools.lru_cache(maxsize=None)
def device_table(code: CodeSpec, device: torch.device) -> torch.Tensor:
    """``packed_transition_table(code)`` on ``device``, uploaded once per code
    and device: an upload from pageable host memory at every launch would make
    the host wait for the stream between the links of a chain."""
    return torch.as_tensor(packed_transition_table(code), device=device)


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
    S, B = metrics_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    _build.check_cuda_int32("metrics_sb", metrics_sb, (code.num_states, B))
    _build.check_cuda_int32("symbols_trb", symbols_trb, (Tp, code.R, B))
    dev = metrics_sb.device
    etab = device_table(code, dev)
    m_out = torch.empty_like(metrics_sb)
    dec = torch.empty((Tp, code.decision_words, B), dtype=torch.int32, device=dev)
    _build.launch(
        "acs_update_tb", "viterbi_acs_tb", dev,
        metrics_sb.data_ptr(), symbols_trb.data_ptr(), etab.data_ptr(), m_out.data_ptr(),
        dec.data_ptr(), code.K, code.R, numeric.soft_low,
        numeric.soft_high + numeric.soft_low, B, t_real, acs_smem_bytes(code))
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
