"""The state-sharded decode's trellis step and traceback on the card.

The JAX package runs the state-sharded ACS and its traceback
(``parallel/statewise.py`` ``_sharded_acs_scan``, ``_sharded_traceback``)
each as one ``lax.scan`` of ``jnp`` inside a ``shard_map``, so these kernels
replace no Pallas kernel; they take the port's scan off a round of some 40
PyTorch launches a step, and its traceback off some 17 and a ``psum``.

* ``sharded_acs_step`` (``csrc/viterbi_shard.cu`` ``sharded_acs_step_kernel``;
  counter ``sharded_acs_scan``): one launch a step for every local target
  shard and frame, a thread a predecessor pair, the two old metrics read
  where the exchange left them, the penalty index from the parities of the
  global predecessor index, the decisions as two interleaved ballots a warp.
* ``sharded_walk`` (``sharded_walk_kernel``; counter ``sharded_traceback``):
  the whole traceback in one launch where every state line lies in this
  process, a warp a (line, frame) resolving five steps a fetch round.
* ``sharded_walk_step`` (``sharded_walk_step_kernel``; counter
  ``sharded_traceback_step``): one traceback step where a line spans
  processes, a thread a (shard, frame): the state update from the previous
  step's sum and the shard's own bit, for the caller's ``psum``.

Their plain versions are ``parallel/statewise.py`` ``_sharded_acs_scan_ref``
and ``_sharded_traceback_ref``, which the routes run on the CPU (this module
only launches).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...configs import CodeSpec
from . import _build

__all__ = ["MAX_TARGETS", "step_constants", "sharded_acs_step", "sharded_walk",
           "sharded_walk_step"]

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


def _walk_layout(name: str, code: CodeSpec, dec: torch.Tensor, n_local: int, tensors_of):
    """The layout checks both walk launchers share: ``dec [T, n, B, W]``
    int32, unit-strided along W; ``n_local`` a power of two up to the
    states, W = ceil(n_local / 32); each of ``tensors_of(T, n, B)`` (name,
    tensor, shape, dtype) contiguous.  Returns ``(T, n, B, lg, tensors)``."""
    S = code.num_states
    if not 1 <= n_local <= S or n_local & (n_local - 1):
        raise ValueError(f"{name}: a shard's states must be a power of two up to {S}, "
                         f"got {n_local}")
    if dec.dim() != 4 or dec.dtype != torch.int32:
        raise ValueError(f"{name}: dec must be [T, n, B, W] int32, got {tuple(dec.shape)} "
                         f"{dec.dtype}")
    T, n, B, W = dec.shape
    if not 1 <= n <= MAX_TARGETS:
        raise ValueError(f"{name}: 1 to {MAX_TARGETS} local shards a launch, got {n}")
    if W != -(-n_local // 32) or dec.stride(-1) != 1:
        raise ValueError(f"{name}: dec must hold {-(-n_local // 32)} unit-strided words a "
                         f"shard and frame, got {W} of stride {dec.stride(-1)}")
    tensors = tensors_of(T, n, B)
    for what, x, shape, dtype in tensors:
        if x.dtype != dtype:
            raise ValueError(f"{name}: {what} must be {str(dtype).removeprefix('torch.')}, "
                             f"got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {what} must have shape {shape}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return T, n, B, n_local.bit_length() - 1, tensors


def _on_card(name: str, dec: torch.Tensor, tensors: list) -> None:
    for what, x in [("dec", dec)] + [(w, x) for w, x, _, _ in tensors]:
        if not x.is_cuda or x.device != dec.device:
            raise ValueError(f"{name}: {what} must lie on a CUDA device, that of dec "
                             f"({dec.device}), got {x.device}")


def sharded_walk(code: CodeSpec, dec: torch.Tensor, end: torch.Tensor, lines: list,
                 n_local: int) -> torch.Tensor:
    """The whole traceback in one launch: ``dec [T, n, B, W]`` the scan's
    words (any strides but W's), ``end [n, B]`` int32 the end states (alike
    along a line), ``lines`` the state lines as local shard indices in axis
    order (each line's shard d holds states ``[d n_local, (d + 1) n_local)``).
    Returns bits ``[n, B, T]`` uint8, every shard of a line its line's."""
    name = "sharded_traceback"
    n_state = len(lines[0]) if lines else 0
    if not lines or any(len(ln) != n_state for ln in lines) or n_state * n_local != (
            code.num_states):
        raise ValueError(f"{name}: lines of {code.num_states // max(n_local, 1)} shards of "
                         f"{n_local} states each, got {[len(ln) for ln in lines]}")
    T, n, B, lg, tensors = _walk_layout(name, code, dec, n_local,
                                        lambda T, n, B: [("end", end, (n, B), torch.int32)])
    flat = [j for ln in lines for j in ln]
    if sorted(flat) != list(range(n)):
        raise ValueError(f"{name}: the lines must hold each of the {n} local shards once, "
                         f"got {lines}")
    _on_card(name, dec, tensors)
    bits = torch.empty((n, B, T), dtype=torch.uint8, device=dec.device)
    st, sn, sb, _ = dec.stride()
    _build.launch(name, "viterbi_shard_walk", dec.device, dec.data_ptr(), st, sn, sb,
                  end.data_ptr(), bits.data_ptr(), (ctypes.c_int * len(flat))(*flat), len(lines),
                  n_state, lg, code.K, B, T)
    return bits


def sharded_walk_step(code: CodeSpec, dec: torch.Tensor, t: int, state: torch.Tensor,
                      ksum: torch.Tensor | None, coords: list, n_local: int, bits: torch.Tensor,
                      bit_out: torch.Tensor) -> None:
    """Step ``t`` of the traceback where a line spans processes: ``state [n,
    B]`` int32 takes ``ksum`` (the previous step's ``psum``, None at ``t = T -
    1``) in place, which is also written to ``bits [n, B, T]`` uint8 at ``t +
    1``; then each shard's own decision bit of the state (0 where another
    shard, ``coords`` its coordinates along the state axis, owns it) goes to
    ``bit_out [n, B]`` int32."""
    name = "sharded_traceback_step"

    def tensors_of(T, n, B):
        return [("state", state, (n, B), torch.int32), ("bits", bits, (n, B, T), torch.uint8),
                ("bit_out", bit_out, (n, B), torch.int32)] + (
                    [] if ksum is None else [("ksum", ksum, (n, B), torch.int32)])

    T, n, B, lg, tensors = _walk_layout(name, code, dec, n_local, tensors_of)
    if not 0 <= t < (T - 1 if ksum is not None else T):
        raise ValueError(f"{name}: step {t} outside the words' {T} steps"
                         + (" (a sum to apply needs a later step)" if ksum is not None else ""))
    if len(coords) != n or not all(0 <= c < code.num_states // n_local for c in coords):
        raise ValueError(f"{name}: a coordinate below {code.num_states // n_local} for each of "
                         f"the {n} shards, got {coords}")
    _on_card(name, dec, tensors)
    st, sn, sb, _ = dec.stride()
    _build.launch(name, "viterbi_shard_walk_step", dec.device, dec.data_ptr(), st, sn, sb,
                  state.data_ptr(), None if ksum is None else ksum.data_ptr(), bits.data_ptr(),
                  bit_out.data_ptr(), (ctypes.c_int * n)(*coords), n, lg, code.K, B, T, t)
