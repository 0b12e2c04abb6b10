"""In-place ACS with rotating state addresses, and its traceback.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py``
(``acs_update_inplace``, ``chainback_inplace``, ``rot_perm``).  The CUDA
kernels are ``acs_inplace_warp_kernel`` (K <= 9), ``acs_inplace_block_kernel``
(K = 10..15) and ``chainback_kernel<ROT=true>`` in ``csrc/viterbi_small.cu``; beside each wrapper is
its plain PyTorch version (``*_ref``) with the same contract, position packing
included.  The ACS kernels do no rotation and no transition-table lookup of
their own: which penalty pattern a position uses at a rotation phase comes
from the host tables below (``pair_tables``, ``position_tables``,
``complement_form``), built once per code with numpy.

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
from ..branch import packed_transition_table
from . import _build
from .kernels import (_check_t_real, _into, _state_order_words, acs_launch_args,
                      check_acs_inputs, complement_form, launch_chainback, metrics_like,
                      walk_ref, words_out)

__all__ = [
    "acs_update_inplace",
    "acs_update_inplace_ref",
    "launch_acs_inplace",
    "chainback_inplace",
    "chainback_inplace_ref",
    "pad_time_inplace",
    "rot_perm",
    "pair_table",
    "pair_tables",
    "position_tables",
    "complement_form",
    "inplace_warps_per_block",
    "inplace_smem_bytes",
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


def _phase_pairs(code: CodeSpec, phase: int):
    """Butterflies of rotation phase ``phase`` by compressed pair index ``i``:
    ``(j, q, s2)`` with the butterfly bit ``j = (K-2-phase) mod (K-1)``, the
    low position ``q`` (``i`` with a zero inserted at bit ``j``; the pair is
    ``q, q | 2^j``) and the predecessor half-state ``s2 = rotl(q, phase)``."""
    nrot = code.K - 1
    j = (code.K - 2 - phase) % nrot
    i = np.arange(code.num_states // 2, dtype=np.int64)
    q = ((i >> j) << (j + 1)) | (i & ((1 << j) - 1))
    return j, q, _rotl(q, phase, nrot)


def pair_table(code: CodeSpec, phase: int) -> np.ndarray:
    """``[S/2]`` int32: ``packed_transition_table(code)`` in compressed
    position order of rotation phase ``phase``.  Bits ``8*(2h+b) .. +R`` of
    entry ``i`` are the penalty pattern (bit ``r``: expected output bit of
    polynomial ``r``) of the branch from predecessor half ``h`` on input bit
    ``b`` in butterfly ``i``: the JAX package's ``rotating_tables_jnp``,
    packed."""
    return packed_transition_table(code)[_phase_pairs(code, phase % (code.K - 1))[2]]


@functools.lru_cache(maxsize=None)
def pair_tables(code: CodeSpec) -> np.ndarray:
    """``[K-1, S/2]`` int32: ``pair_table`` of every phase."""
    return np.stack([pair_table(code, c) for c in range(code.K - 1)])


@functools.lru_cache(maxsize=None)
def position_tables(code: CodeSpec) -> np.ndarray:
    """``[K-1, max(S, 32)]`` int32: for position ``p`` at phase ``c``, the
    pattern of the branch that leaves ``p``'s own old metric in the low byte
    and that of the branch from its partner ``p ^ 2^j`` in the next.  The new
    state at ``p`` takes input bit ``b = bit j of p``; its own old metric is
    the predecessor of half ``h = b``, the partner's that of half ``1 - b``.
    Rows are zero-padded to a warp."""
    S, nrot = code.num_states, code.K - 1
    pairs = pair_tables(code).astype(np.int64)
    out = np.zeros((nrot, max(S, 32)), dtype=np.int32)
    p = np.arange(S, dtype=np.int64)
    for c in range(nrot):
        j = (code.K - 2 - c) % nrot
        b = (p >> j) & 1
        q = p & ~(1 << j)
        e = pairs[c][((q >> (j + 1)) << j) | (q & ((1 << j) - 1))]
        own = (e >> (8 * (2 * b + b))) & 0xFF
        partner = (e >> (8 * (2 * (1 - b) + b))) & 0xFF
        out[c, :S] = own | (partner << 8)
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(code: CodeSpec, device: torch.device):
    """The kernels' tables on ``device``, uploaded once per code and device:
    ``(position_tables, pair_tables, pair_tables' low bytes)``."""
    pairs = pair_tables(code)
    return (torch.as_tensor(position_tables(code), device=device),
            torch.as_tensor(pairs, device=device),
            torch.as_tensor((pairs & 0xFF).astype(np.uint8), device=device))


SMEM_CAP = 220 * 1024    # shared memory the launcher lets a block take (kSmemCap)


def _warp_bytes(code: CodeSpec) -> int:
    nrot = code.K - 1
    stage = (32 // nrot) * nrot
    return 4 * (2 * stage * ((1 << code.R) + 1) + 2 * 32 * code.R)


def inplace_warps_per_block(code: CodeSpec) -> int:
    """Warps a block of the in-place ACS launch, as the launcher in the source
    computes them.  K <= 9 (a warp a frame): as many, up to four, as the
    penalty tables leave room for; ``S/64`` for the block form above."""
    if code.K >= 10:
        return min(32, code.num_states // 64)
    return min(4, max(1, SMEM_CAP // _warp_bytes(code)))


def inplace_smem_bytes(code: CodeSpec) -> int:
    """Dynamic shared memory of one block of the in-place ACS launch.  K <= 9:
    for each warp, two penalty tables of one stage (rows of ``2^R + 1``
    words) and two stages of symbols.  K >= 10: the frame's ``S`` metrics, two
    tables of 32 rows, two stages of symbols, 16 word slots a warp and, for a
    code in complement form where they fit, the pattern bytes of every phase."""
    if code.K >= 10:
        base = 4 * (code.num_states + 2 * 32 * ((1 << code.R) + 1) + 2 * 32 * code.R + 32 * 16)
        pattern_bytes = (code.K - 1) * (code.num_states // 2)
        if complement_form(code) and base + pattern_bytes <= SMEM_CAP:
            return base + pattern_bytes
        return base
    return inplace_warps_per_block(code) * _warp_bytes(code)


def pad_time_inplace(code: CodeSpec, T: int) -> int:
    """Padded length of a position-packed word block: whole traceback words.
    The CUDA kernels have no time block, so this is the only padding unit."""
    return -(-T // CB_TB) * CB_TB


def acs_update_inplace_ref(code: CodeSpec, numeric: NumericSpec, metrics_pos_sb: torch.Tensor,
                           symbols_trb: torch.Tensor, t_real: int, t0: int = 0,
                           out: torch.Tensor | None = None):
    """Plain version of ``acs_update_inplace``: un-rotate, run the
    state-order ACS, then rotate the final metrics and permute each step's
    decisions into position order (words past ``t_real`` are zero; inputs of
    any strides, exit metrics in ``kernels.metrics_like``)."""
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
    return metrics_like(metrics_pos_sb).copy_(m_pos), _into(out, dec)


def acs_update_inplace(code: CodeSpec, numeric: NumericSpec, metrics_pos_sb: torch.Tensor,
                       symbols_trb: torch.Tensor, t_real: int, t0: int = 0,
                       out: torch.Tensor | None = None):
    """Whole-frame in-place ACS.

    Args:
      metrics_pos_sb: ``[S, B]`` int32 of any strides (``m.T`` of a ``[B,
        S]``) in position space of rotation phase ``t0 mod (K-1)`` (state
        order when ``t0 == 0``; ``rot_perm`` converts).
      symbols_trb: ``[Tp, R, B]`` int32 of any strides, ``Tp >= t_real``
        (``s.permute(1, 2, 0)`` of a batch-major ``[B, T, R]``).
      t_real: true number of trellis steps in this call.
      t0: trellis steps consumed before this call.
      out: where the words go (a contiguous ``[Tp, W, B]`` int32 view: rows
        of a stream's window), or None for a new tensor.

    Returns ``(metrics [S, B] in position space of (t0 + t_real) mod (K-1),
    in the layout of kernels.metrics_like(metrics_pos_sb), dec_words [Tp, W,
    B] int32 packed in position order)``.  A CUDA tensor launches the kernel
    or raises.
    """
    if not metrics_pos_sb.is_cuda:
        return acs_update_inplace_ref(code, numeric, metrics_pos_sb, symbols_trb, t_real, t0, out)
    return launch_acs_inplace(code, numeric, metrics_pos_sb, symbols_trb, t_real, t0, out)


def launch_acs_inplace(code: CodeSpec, numeric: NumericSpec, metrics_pos_sb: torch.Tensor,
                       symbols_trb: torch.Tensor, t_real: int, t0: int = 0,
                       out: torch.Tensor | None = None):
    """Check and launch the in-place ACS on metrics and symbols of any
    strides (``acs_update_inplace``'s card route)."""
    if not (2 <= code.K <= 15 and 1 <= code.R <= 8):
        raise ValueError(f"{code.name}: the in-place kernel serves 2 <= K <= 15 and R <= 8")
    t_real = check_acs_inputs(code, metrics_pos_sb, symbols_trb, t_real)
    B, Tp = metrics_pos_sb.shape[1], symbols_trb.shape[0]
    dev = metrics_pos_sb.device
    m_out = metrics_like(metrics_pos_sb)
    dec = words_out(out, code, Tp, B, dev)
    _build.launch(
        "acs_update_inplace", "viterbi_acs_inplace", dev,
        *acs_launch_args(metrics_pos_sb, symbols_trb, _device_tables(code, dev), m_out, dec,
                         (code.K, code.R, int(complement_form(code)), numeric.soft_low,
                          numeric.soft_high + numeric.soft_low, B, t_real,
                          int(t0) % (code.K - 1))))
    return m_out, dec


def chainback_inplace_ref(code: CodeSpec, dec_words: torch.Tensor, endstate, t_real: int,
                          t0: int = 0, form: str = "words", lo: int = 0, hi: int | None = None,
                          *, out: torch.Tensor | None = None, start: torch.Tensor | None = None,
                          metrics: torch.Tensor | None = None,
                          metrics_phase: int = 0) -> torch.Tensor:
    """Plain version of ``chainback_inplace``."""
    return walk_ref(code, dec_words, endstate, t_real, True, int(t0) % (code.K - 1), form, lo,
                    hi, out, start, metrics, metrics_phase)


def chainback_inplace(code: CodeSpec, dec_words: torch.Tensor, endstate, t_real: int,
                      t0: int = 0, form: str = "words", lo: int = 0, hi: int | None = None, *,
                      out: torch.Tensor | None = None, start: torch.Tensor | None = None,
                      metrics: torch.Tensor | None = None, metrics_phase: int = 0) -> torch.Tensor:
    """Traceback over position-packed words from ``acs_update_inplace``.

    Same contract and output forms as ``kernels.chainback_tb``; ``t0`` is
    the absolute trellis step of ``dec_words[0]`` (only ``t0 mod (K-1)``
    matters).  Metrics that ``acs_update_inplace`` returned after
    ``dec_words`` are in position space of phase ``(t0 + t_real) mod
    (K-1)``: pass that as ``metrics_phase``."""
    if not dec_words.is_cuda:
        return chainback_inplace_ref(code, dec_words, endstate, t_real, t0, form, lo, hi,
                                     out=out, start=start, metrics=metrics,
                                     metrics_phase=metrics_phase)
    return launch_chainback("chainback_inplace", True, code, dec_words, endstate, t_real, 15,
                            int(t0) % (code.K - 1), form, lo, hi, out, start, metrics,
                            metrics_phase)
