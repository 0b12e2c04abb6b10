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

A scan and a traceback repeat one launch a step, so each has a launch plan
(``StepPlan``, ``WalkStepPlan``) that checks the layouts, resolves the
launcher and the stream and builds the ctypes arguments once; a step is then
one launcher call with its step index (and which of the fixed buffers it
reads and writes).  ``sharded_acs_step`` and ``sharded_walk_step`` are the
one-step entry points, each a plan of one step.  A step covers any batch:
the launcher issues one kernel launch for each run of ``MAX_B`` frames and
reports how many it made, which is what the counter adds.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...configs import CodeSpec
from . import _build

__all__ = ["MAX_TARGETS", "MAX_B", "StepPlan", "WalkStepPlan", "step_constants",
           "sharded_acs_step", "sharded_walk", "sharded_walk_step"]

MAX_TARGETS = 64  # local target shards a launch (kMaxTargets in the source)
MAX_R = 8         # outputs a symbol group (kMaxR)
MAX_B = 65535     # frames a kernel launch (kMaxFrames: the grid's y extent)


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


def _card(device: torch.device) -> bool:
    """Whether the launchers take tensors on ``device``: a CUDA device (also
    the route of ``parallel/statewise.py``'s scan)."""
    return device.type == "cuda"


def _bind(counter: str, fn_name: str, device: torch.device, tensors: list,
          reported: ctypes.c_int | None = None) -> _build.Bound:
    """The launcher of a plan, bound once.  ``tensors``: what its pointer
    arguments point into (a fake launcher resolves them; the plan holds
    them); ``reported``: where the launcher writes its launches, if it does."""
    return _build.Bound(counter, fn_name, device, reported)


def _array(ctype, values) -> ctypes.Array:
    """A host array of a plan's launcher arguments."""
    return (ctype * len(values))(*values)


def _check(name: str, what: str, x: torch.Tensor, shape: tuple, dtype=torch.int32,
           unit: str | None = None) -> None:
    """``x``'s dtype and shape; contiguous, or (``unit``) unit-strided along its last dimension."""
    if x.dtype != dtype:
        raise ValueError(f"{name}: {what} must be {str(dtype).removeprefix('torch.')}, "
                         f"got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: {what} must have shape {shape}, got {tuple(x.shape)}")
    if unit is not None and x.stride(-1) != 1:
        raise ValueError(f"{name}: {what} must be unit-strided along {unit}")
    if unit is None and not x.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _check_targets(lo: list, hi: list, s2_base: list, R: int) -> None:
    n = len(lo)
    if not 1 <= n <= MAX_TARGETS or len(hi) != n or len(s2_base) != n:
        raise ValueError(f"sharded_acs_scan: 1 to {MAX_TARGETS} targets a launch with a source "
                         f"pair and a base each, got {n}, {len(hi)} and {len(s2_base)}")
    if R > MAX_R:
        raise ValueError(f"sharded_acs_scan: the kernel takes R <= {MAX_R}, got R={R}")
    if lo[0].dim() != 2:
        raise ValueError(f"sharded_acs_scan: lo[0] must be [B, chunk], got {tuple(lo[0].shape)}")


def _check_step(t: int, T: int) -> None:
    if not 0 <= t < T:
        raise ValueError(f"sharded_acs_scan: step {t} outside the tables' {T} steps")


class StepPlan:
    """The launches of a scan's steps (``sharded_acs_step_kernel``), checked
    and bound once.

    ``sources``: one ``(lo, hi, m_out)`` a configuration -- ``lo[j]``,
    ``hi[j]`` the ``[B, chunk]`` int32 old metrics of target j's low and high
    predecessors (any batch stride), ``m_out [n, 2, B, chunk]`` the new
    metrics by half, local state ``h chunk + i`` at ``[j, h, b, i]``:
    contiguous (half-major, the scan's buffers) or the view ``m.view(n, B,
    2, chunk).transpose(1, 2)`` of a contiguous ``m [n, B, 2 chunk]``
    (interleaved); ``s2_base[j]`` target j's first predecessor index; ``tables [n, B, T,
    2^R]`` the scan's penalty tables; ``dec [T, n, B, ceil(2 chunk / 32)]``
    the words, each step's row contiguous (None: no words).  ``step(t, p)``
    runs step ``t`` in configuration ``p``: one launcher call, one kernel
    launch a run of ``MAX_B`` frames, counted as the launcher reports them."""

    def __init__(self, code: CodeSpec, sources: list, s2_base: list, tables: torch.Tensor,
                 dec: torch.Tensor | None):
        name, R = "sharded_acs_scan", code.R
        for lo, hi, _ in sources:
            _check_targets(lo, hi, s2_base, R)
        lo0 = sources[0][0]
        n = len(lo0)
        B, chunk = lo0[0].shape
        T = tables.shape[2] if tables.dim() == 4 else 0
        W = -(-2 * chunk // 32)
        _check(name, "tables", tables, (n, B, T, 1 << R))
        checked = [("tables", tables)]
        if dec is not None:
            _check(name, "dec", dec, (T, n, B, W), unit="the words")
            if any(size > 1 and st != want for size, st, want in
                   zip(dec.shape[1:], dec.stride()[1:], (B * W, W, 1))):
                raise ValueError(f"{name}: each step's row of dec must be contiguous")
            checked.append(("dec", dec))
        half_major = []
        for lo, hi, m_out in sources:
            _check(name, "m_out", m_out, (n, 2, B, chunk), unit="the states")
            # At B = 1 the two layouts are one memory, stored interleaved.
            half_major.append(not m_out.transpose(1, 2).is_contiguous())
            if (half_major[-1] and not m_out.is_contiguous()) or m_out.data_ptr() % 8:
                raise ValueError(f"{name}: m_out must be half-major [n, 2, B, chunk] or "
                                 f"interleaved [n, B, 2 chunk], contiguous and 8-byte aligned")
            checked.append(("m_out", m_out))
            for j in range(n):
                for what, x in ((f"lo[{j}]", lo[j]), (f"hi[{j}]", hi[j])):
                    _check(name, what, x, (B, chunk), unit="s2")
                    checked.append((what, x))
        dev = sources[0][2].device
        for what, x in checked:
            if not _card(x.device) or x.device != dev:
                raise ValueError(f"{name}: {what} must lie on the CUDA device of m_out ({dev}), "
                                 f"got {x.device}")
        masks, offsets = step_constants(code)
        self._made = ctypes.c_int(0)  # the launches of the last call, as the launcher reports
        common = (_array(ctypes.c_longlong, s2_base), n, _array(ctypes.c_uint, masks), R,
                  _array(ctypes.c_int, offsets), tables.data_ptr(), T)
        self._args = []
        for (lo, hi, m_out), hm in zip(sources, half_major):
            self._args.append([
                _array(ctypes.c_longlong, [x.data_ptr() for x in lo]),
                _array(ctypes.c_longlong, [x.stride(0) for x in lo]),
                _array(ctypes.c_longlong, [x.data_ptr() for x in hi]),
                _array(ctypes.c_longlong, [x.stride(0) for x in hi]),
                *common, 0, m_out.data_ptr(), int(hm), None, B, chunk,
                ctypes.pointer(self._made)])
        self.T = T
        self._dec_row = (dec.data_ptr(), dec.stride(0) * 4) if dec is not None else None
        self.tensors = [x for _, x in checked]
        self._launch = _bind(name, "viterbi_shard_step", dev, self.tensors, self._made)

    def step(self, t: int, p: int = 0) -> None:
        _check_step(t, self.T)
        args = self._args[p]
        args[11] = t
        if self._dec_row is not None:
            args[14] = self._dec_row[0] + t * self._dec_row[1]
        self._launch(*args)


def sharded_acs_step(code: CodeSpec, lo: list, hi: list, s2_base: list, tables: torch.Tensor,
                     t: int, m_out: torch.Tensor, dec_row: torch.Tensor | None) -> None:
    """Launch step ``t`` for the ``n`` local target shards: ``lo[j]``,
    ``hi[j]`` the ``[B, chunk]`` int32 old metrics of target j's low and high
    predecessors (any batch stride), ``s2_base[j]`` its first predecessor
    index, ``tables [n, B, T, 2^R]`` the scan's penalty tables; writes the new
    metrics into ``m_out [n, B, 2 chunk]`` and, unless ``dec_row`` is None,
    the packed decisions into ``dec_row [n, B, ceil(2 chunk / 32)]``.  A
    ``StepPlan`` of one step."""
    name = "sharded_acs_scan"
    _check_targets(lo, hi, s2_base, code.R)
    n = len(lo)
    B, chunk = lo[0].shape
    _check_step(t, tables.shape[2] if tables.dim() == 4 else 0)
    _check(name, "m_out", m_out, (n, B, 2 * chunk))
    dec = None
    if dec_row is not None:
        _check(name, "dec_row", dec_row, (n, B, -(-2 * chunk // 32)))
        dec = dec_row.expand(tables.shape[2], *dec_row.shape)  # every step's row is dec_row
    StepPlan(code, [(lo, hi, m_out.view(n, B, 2, chunk).transpose(1, 2))], s2_base, tables,
             dec).step(t)


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
        _check(name, what, x, shape, dtype)
    return T, n, B, n_local.bit_length() - 1, tensors


def _on_card(name: str, dec: torch.Tensor, tensors: list) -> None:
    for what, x in [("dec", dec)] + [(w, x) for w, x, _, _ in tensors]:
        if not _card(x.device) or x.device != dec.device:
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


def _check_walk_step(name: str, t: int, T: int, with_sum: bool) -> None:
    if not 0 <= t < (T - 1 if with_sum else T):
        raise ValueError(f"{name}: step {t} outside the words' {T} steps"
                         + (" (a sum to apply needs a later step)" if with_sum else ""))


class WalkStepPlan:
    """The launches of a traceback's steps where a line spans processes
    (``sharded_walk_step_kernel``), checked and bound once: ``dec [T, n, B,
    W]`` the scan's words (any strides but W's), ``state [n, B]`` int32
    updated in place, ``bits [n, B, T]`` uint8, ``coords`` each local shard's
    coordinate along the state axis, ``outs`` and ``sums`` the ``[n, B]``
    int32 buffers a step writes its bits to and reads the previous step's
    sum from.  ``step(t, k, o)``: step ``t`` reading ``sums[k]`` (None: no
    sum, the first step) and writing ``outs[o]``, one launcher call."""

    def __init__(self, code: CodeSpec, dec: torch.Tensor, state: torch.Tensor, coords: list,
                 n_local: int, bits: torch.Tensor, outs: list, sums: list):
        name = self.name = "sharded_traceback_step"

        def labelled(what, xs):
            return [(what if len(xs) == 1 else f"{what}[{i}]", x) for i, x in enumerate(xs)]

        def tensors_of(T, n, B):
            return ([("state", state, (n, B), torch.int32),
                     ("bits", bits, (n, B, T), torch.uint8)]
                    + [(w, x, (n, B), torch.int32)
                       for w, x in labelled("bit_out", outs) + labelled("ksum", sums)])

        T, n, B, lg, tensors = _walk_layout(name, code, dec, n_local, tensors_of)
        if len(coords) != n or not all(0 <= c < code.num_states // n_local for c in coords):
            raise ValueError(f"{name}: a coordinate below {code.num_states // n_local} for each "
                             f"of the {n} shards, got {coords}")
        _on_card(name, dec, tensors)
        st, sn, sb, _ = dec.stride()
        self._args = [dec.data_ptr(), st, sn, sb, state.data_ptr(), None, bits.data_ptr(), None,
                      _array(ctypes.c_int, coords), n, lg, code.K, B, T, 0]
        self._outs = [x.data_ptr() for x in outs]
        self._sums = [x.data_ptr() for x in sums]
        self.T = T
        self.tensors = [dec] + [x for _, x, _, _ in tensors]
        self._launch = _bind(name, "viterbi_shard_walk_step", dec.device, self.tensors)

    def step(self, t: int, k: int | None, o: int) -> None:
        _check_walk_step(self.name, t, self.T, k is not None)
        args = self._args
        args[5] = None if k is None else self._sums[k]
        args[7] = self._outs[o]
        args[14] = t
        self._launch(*args)


def sharded_walk_step(code: CodeSpec, dec: torch.Tensor, t: int, state: torch.Tensor,
                      ksum: torch.Tensor | None, coords: list, n_local: int, bits: torch.Tensor,
                      bit_out: torch.Tensor) -> None:
    """Step ``t`` of the traceback where a line spans processes: ``state [n,
    B]`` int32 takes ``ksum`` (the previous step's ``psum``, None at ``t = T -
    1``) in place, which is also written to ``bits [n, B, T]`` uint8 at ``t +
    1``; then each shard's own decision bit of the state (0 where another
    shard, ``coords`` its coordinates along the state axis, owns it) goes to
    ``bit_out [n, B]`` int32.  A ``WalkStepPlan`` of one step."""
    name = "sharded_traceback_step"
    if dec.dim() == 4:
        _check_walk_step(name, t, dec.shape[0], ksum is not None)
    WalkStepPlan(code, dec, state, coords, n_local, bits, [bit_out],
                 [] if ksum is None else [ksum]).step(t, None if ksum is None else 0, 0)
