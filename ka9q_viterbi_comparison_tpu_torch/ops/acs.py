"""Add-compare-select (ACS) symbol update: the port's portable path.

Port of ``ka9q_viterbi_comparison_tpu/ops/acs.py`` (``init_metrics``,
``acs_step``, ``acs_update``, ``acs_update_rotating``), the reference's hot loop #1
(ref: ka9q_libfec_port/viterbi27_sse2.cpp:119-175).  The time loop is a Python
loop of whole-state-vector tensor ops over ``[B, S]``; it runs on any device,
and is the CPU oracle the CUDA kernels' plain versions are held against.

Butterfly (viterbi27_sse2.cpp:149-166): new state ``2*s2 + b`` selects the
better of predecessor ``s2`` (decision 0) and ``s2 + S/2`` (decision 1).  Ties
keep the low predecessor (ka9q's strict ``cmpgt`` select,
viterbi27_sse2.cpp:155-156).  Metrics are int32; decision words are int32
tensors holding the uint32 pattern, bit ``s % 32`` of word ``s // 32`` for new
state ``s``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec
from ..utils.bits import pack_bits_to_words
from .branch import branch_penalties, penalty_base_and_coef, transition_tables

__all__ = ["init_metrics", "acs_update", "acs_step", "acs_update_rotating"]


def init_metrics(
    code: CodeSpec,
    numeric: NumericSpec,
    batch: int,
    starting_state: int = 0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Fresh path metrics ``[B, S]`` int32, biasing the known start state
    (ref: init_viterbi27_sse2, viterbi27_sse2.cpp:42-53)."""
    m = torch.full((batch, code.num_states), numeric.initial_margin,
                   dtype=torch.int32, device=device)
    m[:, starting_state & (code.num_states - 1)] = 0
    return m


def acs_step(metrics: torch.Tensor, pen: torch.Tensor):
    """One trellis step.

    metrics: ``[B, S]`` int32; pen: ``[B, 4, S/2]`` int32 indexed ``h*2 + b``.
    Returns ``(new_metrics [B, S], decisions [B, S] bool)`` where decision bit
    for new state ``2*s2 + b`` is 1 iff the ``s2 + S/2`` predecessor won.
    """
    half = metrics.shape[-1] // 2
    old_lo = metrics[..., :half]
    old_hi = metrics[..., half:]
    cand = []
    decs = []
    for b in (0, 1):
        c_lo = old_lo + pen[..., 0 * 2 + b, :]
        c_hi = old_hi + pen[..., 1 * 2 + b, :]
        d = c_hi < c_lo
        cand.append(torch.where(d, c_hi, c_lo))
        decs.append(d)
    # Interleave: new[2*s2 + b] = cand[b][s2].
    new = torch.stack(cand, dim=-1).reshape(metrics.shape)
    dec = torch.stack(decs, dim=-1).reshape(metrics.shape)
    return new, dec


def _pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """bool ``[..., S]`` -> words ``[..., W]`` int32 (uint32 pattern; padded to
    32 bits if S < 32)."""
    S = dec.shape[-1]
    if S < 32:
        dec = torch.nn.functional.pad(dec, (0, 32 - S))
    return pack_bits_to_words(dec)


def acs_update(
    code: CodeSpec,
    numeric: NumericSpec,
    metrics: torch.Tensor,
    symbols: torch.Tensor,
    fused_penalties: bool = False,
):
    """Run the symbol update over a block of symbols.

    Args:
      metrics: ``[B, S]`` int32 carry (from ``init_metrics`` or a previous
        block -- blockwise calls match the reference's resumable ``update``,
        ref: viterbi27_sse2.cpp:119).
      symbols: ``[B, T, R]`` int32 soft symbols.
      fused_penalties: build each step's penalties inside the loop from the
        transition tables instead of materialising the block's
        ``[B, T, 4, S/2]`` penalty tensor up front.

    Returns:
      (metrics ``[B, S]`` int32, decision words ``[B, T, W]`` int32,
       renorm offset ``[B]`` int32 -- total amount subtracted from every
       metric by renormalisation, ref: viterbi615_sse2.cpp:76, :157-183).
    """
    B, T, R = symbols.shape
    interval = numeric.renorm_interval
    symbols = symbols.to(torch.int32)
    offset = torch.zeros((B,), dtype=torch.int32, device=metrics.device)

    if fused_penalties:
        tables = torch.as_tensor(transition_tables(code), device=metrics.device).to(torch.int32)
        base_all, coef_all = penalty_base_and_coef(numeric, symbols)  # [B,T], [B,T,R]
        # When every polynomial taps both register ends, flipping (h, b)
        # together flips no expected bit: pen(1,1) = pen(0,0) and
        # pen(0,1) = pen(1,0) -- two penalty builds per step instead of four.
        both_ends = all(
            (p & 1) and (p >> (code.K - 1)) & 1 for p in code.abs_polys())

        def pens_at(t):
            base, coef = base_all[:, t, None], coef_all[:, t]

            def build(hb):
                pen = base
                for r in range(R):
                    pen = pen + coef[:, r, None] * tables[hb, r]
                return pen

            if both_ends:
                p00, p10 = build(0), build(2)
                return torch.stack([p00, p10, p10, p00], dim=1)
            return torch.stack([build(hb) for hb in range(4)], dim=1)
    else:
        pens = branch_penalties(code, numeric, symbols)  # [B, T, 4, S/2]

        def pens_at(t):
            return pens[:, t]

    words = []
    m = metrics.to(torch.int32)
    for t in range(T):
        m, dec = acs_step(m, pens_at(t))
        if interval and t % interval == interval - 1:
            shift = m.min(dim=-1).values
            m = m - shift[:, None]
            offset = offset + shift
        words.append(_pack_decisions(dec))
    if words:
        out = torch.stack(words, dim=1)
    else:
        out = torch.empty((B, 0, code.decision_words), dtype=torch.int32,
                          device=metrics.device)
    return m, out, offset


def _rotl_index(nbits: int, r: int) -> np.ndarray:
    """``perm[p] = rotl(p, r)`` over ``nbits``-bit indices."""
    p = np.arange(1 << nbits, dtype=np.int64)
    r %= nbits
    return ((p << r) | (p >> (nbits - r))) & ((1 << nbits) - 1) if r else p


def acs_update_rotating(
    code: CodeSpec,
    numeric: NumericSpec,
    metrics: torch.Tensor,
    symbols: torch.Tensor,
    t0: int = 0,
):
    """Symbol update with rotating state addresses, in plain PyTorch.

    Same contract as ``acs_update`` (metrics in and out in state order), but
    the decision words come back packed in *position* order: bit
    ``rotr(s, (t0 + t + 1) mod (K-1))`` of step ``t``'s words is the decision
    of new state ``s``, the packing of the in-place kernel, which
    ``chainback.walk(..., rotated=True)`` reads.

    At global step ``t`` the metric of state ``s`` sits at position
    ``rotr(s, t mod (K-1))``.  The two predecessors of a butterfly then
    differ in position bit ``j = (K - 2 - t) mod (K-1)``, and its two new
    states land on the same two positions, so a step is an elementwise
    compare-select between the halves of ``[B, G, 2, 2^j]`` with no
    interleave of the state axis.

    ``t0``: trellis steps consumed before this call (only ``t0 mod (K-1)``
    matters).  With ``numeric.renorm_interval`` set, the schedule counts the
    steps of this call.
    """
    B, T, R = symbols.shape
    K = code.K
    nrot = K - 1
    S = code.num_states
    interval = numeric.renorm_interval
    t0 = int(t0) % nrot
    dev = metrics.device
    tables = torch.as_tensor(transition_tables(code), device=dev).to(torch.int32)  # [4, R, S/2]
    base_all, coef_all = penalty_base_and_coef(numeric, symbols)  # [B, T], [B, T, R]

    phase_tables: dict[int, torch.Tensor] = {}

    def tables_at(phase: int, j: int) -> torch.Tensor:
        """``[4, R, G, 2^j]``: the pair entry of the state whose metric sits
        at low position ``(g << (j + 1)) | r``."""
        if phase not in phase_tables:
            stride, G = 1 << j, S >> (j + 1)
            q = (np.arange(G)[:, None] << (j + 1)) | np.arange(stride)[None, :]
            s2 = _rotl_index(nrot, phase)[q]
            phase_tables[phase] = tables[:, :, torch.as_tensor(s2.reshape(-1), device=dev)].reshape(
                4, R, G, stride)
        return phase_tables[phase]

    m = metrics.to(torch.int32)[:, torch.as_tensor(_rotl_index(nrot, t0), device=dev)]
    offset = torch.zeros((B,), dtype=torch.int32, device=dev)
    words = []
    for t in range(T):
        phase = (t0 + t) % nrot
        j = (K - 2 - phase) % nrot
        stride, G = 1 << j, S >> (j + 1)
        tb = tables_at(phase, j)
        pen = base_all[:, t, None, None, None].expand(B, 4, G, stride)
        for r in range(R):
            pen = pen + coef_all[:, t, r, None, None, None] * tb[:, r]
        x = m.reshape(B, G, 2, stride)
        c_lo = x[:, None, :, 0] + pen[:, :2]  # [B, 2 (input bit), G, stride]
        c_hi = x[:, None, :, 1] + pen[:, 2:]
        d = c_hi < c_lo
        m = torch.where(d, c_hi, c_lo).permute(0, 2, 1, 3).reshape(B, S)
        dec = d.permute(0, 2, 1, 3).reshape(B, S)
        if interval and t % interval == interval - 1:
            shift = m.min(dim=-1).values
            m = m - shift[:, None]
            offset = offset + shift
        words.append(_pack_decisions(dec))
    out = (torch.stack(words, dim=1) if words else
           torch.empty((B, 0, code.decision_words), dtype=torch.int32, device=dev))
    # position p of phase f holds state rotl(p, f): back to state order
    m = m[:, torch.as_tensor(_rotl_index(nrot, nrot - (t0 + T) % nrot), device=dev)]
    return m, out, offset
