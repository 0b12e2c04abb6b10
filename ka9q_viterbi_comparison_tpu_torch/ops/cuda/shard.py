"""One trellis step of the state-sharded butterfly on the card.

The JAX package runs the state-sharded ACS (``parallel/statewise.py``
``_sharded_acs_scan``) as one ``lax.scan`` of ``jnp`` inside a
``shard_map``, so this kernel replaces no Pallas kernel; it takes the port's
scan off a round of some 40 PyTorch launches a step.
``sharded_acs_step_kernel`` (``csrc/viterbi_shard.cu``; counter
``sharded_acs_scan``): one launch a step for every local target shard and
frame, a thread a predecessor pair, the two old metrics read where the
exchange left them, the penalty index from the parities of the global
predecessor index, the decisions as two interleaved ballots a warp.  Its
plain version is ``parallel/statewise.py`` ``_sharded_acs_scan_ref``, which
``_sharded_acs_scan`` runs on the CPU (this module only launches).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...configs import CodeSpec
from . import _build

__all__ = ["MAX_TARGETS", "step_constants", "sharded_acs_step"]

MAX_TARGETS = 64  # local target shards a launch (kMaxTargets in the source)
MAX_R = 8         # outputs a symbol group (kMaxR)
MAX_B = 65535     # frames a launch (the grid's y extent)


@functools.lru_cache(maxsize=None)
def step_constants(code: CodeSpec) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """``(masks, offsets)``: ``|poly_r| >> 1`` for each output r, whose
    parity over the predecessor index ``s2`` is the varying part of the
    expected bit; and the pattern's constant part ``c(h, bit)`` at index
    ``2 h + bit``, bit r = ``(bit & p) ^ (h & p >> (K-1)) ^ inverted_r``."""
    K = code.K
    polys, invs = code.abs_polys(), code.inversions()
    masks = tuple(p >> 1 for p in polys)
    offsets = tuple(sum((((bit & p & 1) ^ (h & (p >> (K - 1)) & 1) ^ int(inv)) << r)
                        for r, (p, inv) in enumerate(zip(polys, invs)))
                    for h in (0, 1) for bit in (0, 1))
    return masks, offsets


def sharded_acs_step(code: CodeSpec, lo: list, hi: list, s2_base: list, tables: torch.Tensor,
                     t: int, m_out: torch.Tensor, dec_row: torch.Tensor | None) -> None:
    """Launch step ``t`` for the ``n`` local target shards: ``lo[j]``,
    ``hi[j]`` the ``[B, chunk]`` int32 old metrics of target j's low and high
    predecessors (any batch stride), ``s2_base[j]`` its first predecessor
    index, ``tables [n, B, T, 2^R]`` the scan's penalty tables; writes the new
    metrics into ``m_out [n, B, 2 chunk]`` and, unless ``dec_row`` is None,
    the packed decisions into ``dec_row [n, B, ceil(2 chunk / 32)]``."""
    n, R = len(lo), code.R
    if not 1 <= n <= MAX_TARGETS or len(hi) != n or len(s2_base) != n:
        raise ValueError(f"sharded_acs_scan: 1 to {MAX_TARGETS} targets a launch with a source "
                         f"pair and a base each, got {n}, {len(hi)} and {len(s2_base)}")
    if R > MAX_R:
        raise ValueError(f"sharded_acs_scan: the kernel takes R <= {MAX_R}, got R={R}")
    if lo[0].dim() != 2:
        raise ValueError(f"sharded_acs_scan: lo[0] must be [B, chunk], got {tuple(lo[0].shape)}")
    B, chunk = lo[0].shape
    if B > MAX_B:
        raise ValueError(f"sharded_acs_scan: the kernel takes B <= {MAX_B}, got B={B}")
    T = tables.shape[2] if tables.dim() == 4 else 0
    if not 0 <= t < T:
        raise ValueError(f"sharded_acs_scan: step {t} outside the tables' {T} steps")
    layouts = [("tables", tables, (n, B, T, 1 << R)), ("m_out", m_out, (n, B, 2 * chunk))]
    if dec_row is not None:
        layouts.append(("dec_row", dec_row, (n, B, -(-2 * chunk // 32))))
    layouts += [(f"{name}[{j}]", x[j], (B, chunk)) for j in range(n) for name, x in
                (("lo", lo), ("hi", hi))]
    for name, x, shape in layouts:
        if x.dtype != torch.int32:
            raise ValueError(f"sharded_acs_scan: {name} must be int32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"sharded_acs_scan: {name} must have shape {shape}, "
                             f"got {tuple(x.shape)}")
        if name[:2] in ("lo", "hi") and x.stride(-1) != 1:
            raise ValueError(f"sharded_acs_scan: {name} must be unit-strided along s2")
        if name[:2] not in ("lo", "hi") and not x.is_contiguous():
            raise ValueError(f"sharded_acs_scan: {name} must be contiguous")
    dev = m_out.device
    for name, x, _ in layouts:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"sharded_acs_scan: {name} must lie on the CUDA device of m_out "
                             f"({dev}), got {x.device}")
    masks, offsets = step_constants(code)
    i64 = ctypes.c_longlong * n
    _build.launch("sharded_acs_scan", "viterbi_shard_step", dev,
                  i64(*(x.data_ptr() for x in lo)), i64(*(x.stride(0) for x in lo)),
                  i64(*(x.data_ptr() for x in hi)), i64(*(x.stride(0) for x in hi)),
                  i64(*s2_base), n, (ctypes.c_uint * R)(*masks), R, (ctypes.c_int * 4)(*offsets),
                  tables.data_ptr(), T, t, m_out.data_ptr(),
                  None if dec_row is None else dec_row.data_ptr(), B, chunk)
