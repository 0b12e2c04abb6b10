"""In-place ACS with rotating state addresses, and its traceback.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py``
(``acs_update_inplace``, ``chainback_inplace``, ``rot_perm``).  The CUDA
kernels are ``acs_inplace_kernel`` and ``chainback_kernel<true>`` in
``csrc/viterbi_small.cu``; beside each wrapper is its plain PyTorch version
(``*_ref``) with the same contract, position packing included.

Addressing: at global trellis step ``t`` the metric of state ``s`` sits at
position ``rotr(s, t mod (K-1))``; the butterfly of step ``t`` then reads and
writes the same two positions, so one metric buffer suffices.  The decisions
of step ``t`` are packed in position order of step ``t+1``: the bit of new
state ``s`` sits at position ``rotr(s, (t+1) mod (K-1))``.  ``t0`` is the
global step of a call's first step, so blockwise calls stay consistent.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import unpack_words_to_bits
from ..acs import _pack_decisions
from . import _build
from .kernels import (_check_t_real, _state_order_words, acs_smem_bytes, device_table,
                      launch_chainback, walk_ref)

__all__ = [
    "acs_update_inplace",
    "acs_update_inplace_ref",
    "chainback_inplace",
    "chainback_inplace_ref",
    "pad_time_inplace",
    "rot_perm",
    "CB_TB",
]

CB_TB = 32  # traceback bits per packed output word


def _rotl(x, t, nbits):
    t %= nbits
    mask = (1 << nbits) - 1
    if t == 0:
        return x & mask
    return ((x << t) | (x >> (nbits - t))) & mask


def _rotr(x, t, nbits):
    return _rotl(x, (nbits - t % nbits) % nbits, nbits)


@functools.lru_cache(maxsize=None)
def rot_perm(code: CodeSpec, t: int, inverse: bool = False) -> np.ndarray:
    """State-axis gather indices between state order and position space.

    Forward (``inverse=False``): ``m_pos = m_state[perm]`` for rotation
    phase ``t`` (``perm[q] = rotl(q, t)``).  Inverse: ``m_state =
    m_pos[perm]`` (``perm[s] = rotr(s, t)``)."""
    nrot = code.K - 1
    t = t % nrot
    s = np.arange(code.num_states, dtype=np.int64)
    return (_rotr(s, t, nrot) if inverse else _rotl(s, t, nrot)).astype(np.int64)


def pad_time_inplace(code: CodeSpec, T: int) -> int:
    """Padded length of a position-packed word block: whole traceback words.
    The CUDA kernels have no time block, so this is the only padding unit."""
    return -(-T // CB_TB) * CB_TB


def acs_update_inplace_ref(code: CodeSpec, numeric: NumericSpec, metrics_pos_sb: torch.Tensor,
                           symbols_trb: torch.Tensor, t_real: int, t0: int = 0):
    """Plain version of ``acs_update_inplace``: un-rotate, run the
    state-order ACS, then rotate the final metrics and permute each step's
    decisions into position order (words past ``t_real`` are zero)."""
    S, B = metrics_pos_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    dev = metrics_pos_sb.device
    idx = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    m_state = metrics_pos_sb[idx(rot_perm(code, t0, inverse=True))].to(torch.int32)
    m, words = _state_order_words(code, numeric, m_state.T,
                                  symbols_trb[:t_real].permute(2, 0, 1))
    m_pos = m.T[idx(rot_perm(code, t0 + t_real))]
    dec = torch.zeros((Tp, code.decision_words, B), dtype=torch.int32, device=dev)
    # Steps in chunks, so that the unpacked bits of one chunk stay near
    # 2^27 elements (K=15 at B=256 would need 8.6e9 at once).
    chunk = max(1, (1 << 27) // (B * max(S, 32)))
    for lo in range(0, t_real, chunk):
        hi = min(lo + chunk, t_real)
        bits = unpack_words_to_bits(words[:, lo:hi])[..., :S]  # [B, c, S] state order
        perms = idx(np.stack([rot_perm(code, t0 + t + 1) for t in range(lo, hi)]))  # [c, S]
        bits_pos = bits.gather(2, perms[None].expand(B, -1, -1))
        dec[lo:hi] = _pack_decisions(bits_pos).permute(1, 2, 0)
    return m_pos.contiguous(), dec


def acs_update_inplace(code: CodeSpec, numeric: NumericSpec, metrics_pos_sb: torch.Tensor,
                       symbols_trb: torch.Tensor, t_real: int, t0: int = 0):
    """Whole-frame in-place ACS.

    Args:
      metrics_pos_sb: ``[S, B]`` int32 in position space of rotation phase
        ``t0 mod (K-1)`` (state order when ``t0 == 0``; ``rot_perm``
        converts).
      symbols_trb: ``[Tp, R, B]`` int32, ``Tp >= t_real``.
      t_real: true number of trellis steps in this call.
      t0: trellis steps consumed before this call.

    Returns ``(metrics [S, B] in position space of (t0 + t_real) mod (K-1),
    dec_words [Tp, W, B] int32 packed in position order)``.
    """
    if not metrics_pos_sb.is_cuda:
        return acs_update_inplace_ref(code, numeric, metrics_pos_sb, symbols_trb, t_real, t0)
    S, B = metrics_pos_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    _build.check_cuda_int32("metrics_pos_sb", metrics_pos_sb, (code.num_states, B))
    _build.check_cuda_int32("symbols_trb", symbols_trb, (Tp, code.R, B))
    dev = metrics_pos_sb.device
    etab = device_table(code, dev)
    m_out = torch.empty_like(metrics_pos_sb)
    dec = torch.empty((Tp, code.decision_words, B), dtype=torch.int32, device=dev)
    _build.launch(
        "acs_update_inplace", "viterbi_acs_inplace", dev,
        metrics_pos_sb.data_ptr(), symbols_trb.data_ptr(), etab.data_ptr(), m_out.data_ptr(),
        dec.data_ptr(), code.K, code.R, numeric.soft_low,
        numeric.soft_high + numeric.soft_low, B, t_real, int(t0) % (code.K - 1),
        acs_smem_bytes(code, True))
    return m_out, dec


def chainback_inplace_ref(code: CodeSpec, dec_words: torch.Tensor, endstate: torch.Tensor,
                          t_real: int, t0: int = 0) -> torch.Tensor:
    """Plain version of ``chainback_inplace``."""
    return walk_ref(code, dec_words, endstate, t_real, rotated=True,
                    p0=int(t0) % (code.K - 1))


def chainback_inplace(code: CodeSpec, dec_words: torch.Tensor, endstate: torch.Tensor,
                      t_real: int, t0: int = 0) -> torch.Tensor:
    """Traceback over position-packed words from ``acs_update_inplace``.

    Same contract as ``kernels.chainback_tb``; ``t0`` is the absolute trellis
    step of ``dec_words[0]`` (only ``t0 mod (K-1)`` matters)."""
    if not dec_words.is_cuda:
        return chainback_inplace_ref(code, dec_words, endstate, t_real, t0)
    return launch_chainback("chainback_inplace", "viterbi_chainback_inplace", code, dec_words,
                            endstate, t_real, int(t0) % (code.K - 1))
