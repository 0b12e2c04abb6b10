"""Bit-plane radix traceback: one dependent fetch per 4 or 8 trellis steps.

Port of ``ka9q_viterbi_comparison_tpu/ops/radix_planes.py`` (``plane_plan``,
``_spread``, ``_plane_gather``, ``build_plane_tables``,
``chainback_plane_bits``, ``chainback_planes``).  Plain PyTorch on tensors of
any device, as the JAX package computes all of it outside its kernels.

The plain K=24 traceback is a chain of dependent fetches, one per frame and
trellis step, so the cure is to retire more steps per fetch.  The width-8
field of state ``s`` over the window ``[t0, t0 + 8)`` telescopes,

    F_8(s) = G_8(s) << 4 | G_4(s) << 2 | G_2(s) << 1 | D(t0 + 7, s)

where each ``G_2v(s) = F_v^lo[pred_v(s)]`` is the half newly prepended: the
earlier sub-window's field at the predecessor the later half walks to.  The
G levels are canonical packed bit planes (bit ``s & 31`` of word ``s >> 5``,
the decision-word layout), and the gather ``lo[(s >> v) | (F << (n - v))]``
is word-parallel: the source bits of output word ``k`` under candidate
``F = c`` are bits ``[k nb, (k + 1) nb)`` of candidate ``c``'s plane region,
``nb = 32 >> v``.  The field bits of every full window are packed per state
into one word table, nibbles at width 4 (``f4``), bytes at width 8 (``f8``),
so the walk fetches one word per window and frame; windows are anchored at
``t = anchor (mod width)`` with ``anchor = K - 1`` for frame decodes, where
the walk stops at the first kept data bit.

All plane tensors are time-major ``[T, B, W]`` int32 holding uint32 bits.
int32 right shifts are arithmetic: every one below is followed by a mask
that drops the sign fill.

Semantics are those of ``ops.chainback`` (decision bit ``k`` at step ``t``,
state ``s``: decoded bit ``t`` is ``k``, next state ``(s >> 1) | (k << (K-2))``),
so the tables can be held against the plain walk on arbitrary words.  The
depth-4 update kernel (``ops.cuda.large_k4``) writes ``f4`` / ``f8`` itself;
this module is the portable construction and what that kernel is tested
against.  Needs ``K - 1 >= 9`` (every combine reads whole-word source runs).
"""

from __future__ import annotations

import torch

from ..configs import CodeSpec
from ..utils.bits import bits_to_bytes

__all__ = ["build_plane_tables", "chainback_plane_bits", "chainback_planes",
           "plane_plan", "MIN_N", "W_WALK"]

MIN_N = 9   # minimum K-1: the v=4 combine reads 2-bit runs from W >= 16 words
W_WALK = 4  # default steps per fetch of ``build_plane_tables`` (8: ``max_width=8``)


def plane_plan(T: int, anchor: int, max_width: int = W_WALK) -> list[tuple[int, int]]:
    """Segments ``(t0, width)`` covering ``[anchor, T)``, in walk
    (descending-t) order.  Full ``max_width`` windows at ``t0 = anchor (mod
    max_width)``; the remainder below T is covered by descending
    power-of-two widths, each ending on a multiple of its width (relative to
    anchor) so its tables exist."""
    segs: list[tuple[int, int]] = []
    t = T
    while t > anchor:
        width = max_width
        while width > 1 and (t - width < anchor or (t - anchor) % width):
            width //= 2
        segs.append((t - width, width))
        t -= width
    return segs


def _spread(x: torch.Tensor, v: int) -> torch.Tensor:
    """Repeat each of the low ``32 >> v`` bits of ``x`` ``2^v`` times
    (``x`` holds no other bits)."""
    if v == 1:  # 16 bits -> each x2
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x | (x << 1)
    if v == 2:  # 8 bits -> each x4
        x = (x | (x << 12)) & 0x000F000F
        x = (x | (x << 6)) & 0x03030303
        x = (x | (x << 3)) & 0x11111111
        x = x | (x << 1)
        return x | (x << 2)
    if v == 4:  # 2 bits -> each x16
        lo = x & 1
        hi = (x >> 1) & 1
        return lo * 0x0000FFFF | hi * -0x10000  # 0xFFFF0000 as an int32
    raise ValueError(f"unsupported spread width {v}")


def _plane_gather(lo_planes, f_planes, v: int):
    """``out_p[s] = lo_planes[p][(s >> v) | (F(s) << (n - v))]`` for every
    plane; bit j of ``F(s)`` is ``f_planes[j]``.  All canonical packed
    ``[..., W]`` bit planes over the state axis (any leading dims).

    Output word ``k = q 2^v + r`` takes bits ``[r nb, (r + 1) nb)`` of lo
    word ``q`` in candidate region c (``nb = 32 >> v``; region c is the word
    slice ``[c Q, (c + 1) Q)``): repeat each source word ``2^v`` times along
    the word axis, shift by ``nb (k mod 2^v)``, mask, spread; the candidate
    masks are word-wise ANDs of the hi window's planes."""
    W = lo_planes[0].shape[-1]
    Q = W >> v
    nb = 32 >> v
    run_mask = (1 << nb) - 1
    dev = lo_planes[0].device
    r_shift = (torch.arange(W, dtype=torch.int32, device=dev) & ((1 << v) - 1)) * nb
    accs = [None] * len(lo_planes)
    for c in range(1 << v):
        m = None
        for j in range(v):
            pj = f_planes[j] if (c >> j) & 1 else ~f_planes[j]
            m = pj if m is None else m & pj
        for i, lp in enumerate(lo_planes):
            rep = lp[..., c * Q:(c + 1) * Q].repeat_interleave(1 << v, dim=-1)
            cand = m & _spread((rep >> r_shift) & run_mask, v)
            accs[i] = cand if accs[i] is None else accs[i] | cand
    return accs


def build_plane_tables(code: CodeSpec, words: torch.Tensor, anchor: int = 0,
                       g2: torch.Tensor | None = None, max_width: int = W_WALK) -> dict:
    """Build the walk tables from time-major decision words ``[T, B, W]``
    int32 (``[B, T, W]`` callers pass ``words.transpose(0, 1)``).

    Windows are anchored at ``t = anchor (mod width)``: ``anchor = K - 1``
    for whole-frame decodes, so that the walk stops at the first kept data
    bit; ``anchor = 0`` gives a full walk to t=0.  Steps below ``anchor``
    get no windows.

    Returns ``{"f4": [n4, 4, B, W], "g2": [n2, B, W]}``: state ``s``'s
    4-step field in nibble ``(s >> 2) & 7`` of word ``(plane s & 3, s >> 5)``
    of its window, and the G_2 plane of every step pair (the walk's width-2
    remainder segments read it); with ``max_width=8`` also ``"f8": [n8, 8, B,
    W]``, state ``s``'s 8-step field in byte ``s & 3`` of word ``(plane
    (s >> 2) & 7, s >> 5)``.  ``g2`` may be supplied by the producer
    (``acs_update_large2(want_g2=True)``; only valid for even anchors, since
    kernel pairs start at even steps).
    """
    n = code.K - 1
    if n < MIN_N:
        raise ValueError(f"plane tables need K-1 >= {MIN_N}, got {n}")
    if max_width not in (4, 8):
        raise ValueError(f"max_width must be 4 or 8, got {max_width}")
    words = words.to(torch.int32)
    T, B, W = words.shape
    Tn = T - anchor
    tables: dict[str, torch.Tensor] = {}

    # Every combine runs over all windows at once: [windows, B, W] stacks.
    if g2 is None:
        n2 = Tn // 2
        d_lo = words[anchor:anchor + 2 * n2:2]
        d_hi = words[anchor + 1:anchor + 2 * n2:2]
        (g2,) = _plane_gather([d_lo], [d_hi], 1)
    tables["g2"] = g2

    # Level 4: window [a + 4p, a + 4p + 4).  F_2 of a 2-window is (G_2 << 1) |
    # D(last); the hi 2-window is [a + 4p + 2, a + 4p + 4), the lo one before it.
    n4 = Tn // 4
    d1_lo = words[anchor + 1:anchor + 4 * n4:4]
    d1_hi = words[anchor + 3:anchor + 4 * n4:4]
    g2_lo = g2[0:2 * n4:2]
    g2_hi = g2[1:2 * n4:2]
    g4_0, g4_1 = _plane_gather([d1_lo, g2_lo], [d1_hi, g2_hi], 2)

    # Nibble-pack F_4 = (G_4 << 2) | (G_2 << 1) | D(last).  f4[p, d] nibble e
    # holds F_4(32w + 4e + d): bit j's nibble-LSB plane for a fixed d is
    # (plane_j >> d) & 0x11111111.
    d_shift = torch.arange(4, dtype=torch.int32, device=words.device).reshape(1, 4, 1, 1)
    f4 = None
    for j, p in enumerate([d1_hi, g2_hi, g4_0, g4_1]):
        x = ((p[:, None] >> d_shift) & 0x11111111) << j
        f4 = x if f4 is None else f4 | x
    tables["f4"] = f4  # [n4, 4, B, W]

    if max_width == 8:
        # Level 8: window [a + 8p, a + 8p + 8), the 16-candidate v=4 combine.
        n8 = Tn // 8
        d3_lo = words[anchor + 3:anchor + 8 * n8:8]
        d3_hi = words[anchor + 7:anchor + 8 * n8:8]
        g2_4lo = g2[1:4 * n8:4]
        g2_4hi = g2[3:4 * n8:4]
        g4l = [g4_0[0:2 * n8:2], g4_1[0:2 * n8:2]]
        g4h = [g4_0[1:2 * n8:2], g4_1[1:2 * n8:2]]
        g8 = _plane_gather([d3_lo, g2_4lo, *g4l], [d3_hi, g2_4hi, *g4h], 4)
        # Byte-pack the full field: f8[p, d, b, w] holds F_8 of states
        # 32w + 4d + e in byte e.  The low nibble of F_8 is F_4 of the hi
        # 4-window (the mask planes above).
        nib = torch.arange(8, dtype=torch.int32, device=words.device).reshape(1, 8, 1, 1) * 4
        f8 = None
        for j, p in enumerate([d3_hi, g2_4hi, *g4h, *g8]):
            x = (p[:, None] >> nib) & 0xF
            # bit i of the nibble -> bit 8i (byte i's LSB)
            x = (x | (x << 14)) & 0x00030003
            x = ((x | (x << 7)) & 0x01010101) << j
            f8 = x if f8 is None else f8 | x
        tables["f8"] = f8  # [n8, 8, B, W]
    return tables


def _fetch_bit(arr: torch.Tensor, t: int, frames: torch.Tensor, state: torch.Tensor):
    """Bit ``state & 31`` of word ``state >> 5`` of ``arr[t]``, per frame."""
    return (arr[t, frames, state >> 5].long() >> (state & 31)) & 1


def chainback_plane_bits(code: CodeSpec, words: torch.Tensor | None, tables: dict,
                         num_data_bits: int, endstate: torch.Tensor | int = 0, anchor: int = 0):
    """Traceback over the plane tables built at the same ``anchor``: one
    gather per window for all frames (width 4, or 8 when the tables hold
    ``f8``), the state carried as a ``[B]`` tensor.

    ``words`` is time-major ``[T, B, W]`` like the tables.  Walks from t = T
    down to t = ``anchor`` only; decoded bits below ``K - 1`` are
    initial-state bits the caller drops anyway, so ``anchor = K - 1`` saves
    their rounds.  Needs ``anchor <= K - 1``.

    ``words`` may be ``None``: ``T`` is then taken from the table (``f8`` if
    there, else ``f4``), so the plan is full-width windows only and reads
    that table alone, which is what ``ops.cuda.large_k4``'s fields forms
    return.

    Returns ``(bits [B, num_data_bits] uint8, state at anchor [B] int32)``.
    """
    f4 = tables.get("f4")
    f8 = tables.get("f8")
    g2 = tables.get("g2")
    if words is None:
        table = f8 if f8 is not None else f4
        nwin, width, B, W = table.shape
        T = anchor + width * nwin
        dev = table.device
    else:
        T, B, W = words.shape
        dev = words.device
    n = code.K - 1
    if anchor > n:
        raise ValueError("anchor must be <= K-1 (kept bits start at K-1)")
    mask = code.num_states - 1
    state = (torch.as_tensor(endstate, dtype=torch.int64, device=dev) & mask).expand(B).clone()
    frames = torch.arange(B, device=dev)

    cols = []
    for t0, width in plane_plan(T, anchor, 8 if f8 is not None else 4):
        a0 = t0 - anchor
        if width == 8:
            word = f8[a0 // 8, (state >> 2) & 7, frames, state >> 5].long()
            F = (word >> ((state & 3) * 8)) & 0xFF
        elif width == 4:
            word = f4[a0 // 4, state & 3, frames, state >> 5].long()
            F = (word >> (((state >> 2) & 7) * 4)) & 0xF
        elif width == 2:
            F = (_fetch_bit(g2, a0 // 2, frames, state) << 1) | _fetch_bit(words, t0 + 1, frames,
                                                                           state)
        else:
            F = _fetch_bit(words, t0, frames, state)
        state = (state >> width) | (F << (n - width))
        shifts = torch.arange(width - 1, -1, -1, device=dev)
        cols.append(((F[:, None] >> shifts) & 1).to(torch.uint8))
    bits = (torch.cat(cols[::-1], dim=1) if cols else
            torch.empty((B, 0), dtype=torch.uint8, device=dev))
    keep0 = code.K - 1 - anchor
    return bits[:, keep0:keep0 + num_data_bits], state.to(torch.int32)


def chainback_planes(code: CodeSpec, words: torch.Tensor | None, tables: dict,
                     num_data_bits: int, endstate: torch.Tensor | int = 0,
                     anchor: int = 0) -> torch.Tensor:
    """Decode to bytes ``[B, num_data_bits // 8]`` uint8 (MSB-first)."""
    bits, _ = chainback_plane_bits(code, words, tables, num_data_bits, endstate, anchor)
    return bits_to_bytes(bits)
