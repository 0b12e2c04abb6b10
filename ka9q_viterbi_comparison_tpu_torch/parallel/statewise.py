"""State-sharded trellis decoding for very large constraint lengths (K=24).

Port of ``ka9q_viterbi_comparison_tpu/parallel/statewise.py``.  The
``state`` mesh axis splits the new states into contiguous blocks, one a
shard, and each trellis step performs the butterfly's cross-shard exchange
explicitly: shard ``d`` owns new states ``[d*S/n, (d+1)*S/n)``, whose
predecessor pairs ``s2 in [d*S/(2n), (d+1)*S/(2n))`` live in the low half
of old-state shard ``d // 2`` and the high half of shard ``d // 2 + n/2``;
so every shard sends the two halves of its old metrics on, four half-shard
``ppermute``s a step.

Branch penalties come from polynomial parity over the local predecessor
block, using

    parity(((s2 << 1) | b | h << (K-1)) & p)
      = parity(s2 & (p >> 1)) ^ (b & p) ^ (h & (p >> (K-1)))

so only ``parity(s2 & (p >> 1))`` varies across the block.  The port
computes it once a shard, as a ``[chunk]`` index of the expected-bit
pattern, and a step looks its penalties up in a ``[B, 2^R]`` table of the
step's symbols.

The decisions stay bit-packed, ``[T, n_local_shards, B, n_local/32]`` int32
(ICE at B=8 over four shards: 0.7 GB, where bool would take 5.8 GB).  The
traceback walks the survivor serially; each step the owner's decision bit
is read with a gather and summed over the shards with one ``psum`` of
``[B]`` int32 (the JAX module's ``psum`` of a one-hot selection; the bits
are equal).

The JAX module's scan and traceback are ``jnp`` with no Pallas kernel
behind them; JAX compiles each into one program.  Here each takes its route
by device, and on a card does its host work once a scan, as a compile would.
The scan (``_on_kernel``): on a CUDA device one launch a step of
``sharded_acs_step_kernel`` (``ops/cuda/shard.py``) for every local shard
and frame, each target's old metrics read where the exchange left them
(``Mesh.plan_exchange``: halves of the local shards in place, buffers that
NCCL fills across processes), the penalty index computed in the kernel.
Its two ping-pong metric buffers are half-major, ``[n, 2, B, chunk]``,
across processes, so that each half a process sends is contiguous, and
interleaved, ``[n, B, 2 chunk]``, in one process, which sends nothing and
whose kernel stores a little faster so; the exchange of each parity and
the step's launcher arguments (``shard.StepPlan``) are built before the
first step, so a step is one launcher call and, across processes, one batch
of transfers.  The traceback (``_walk_on_kernel``): on a CUDA device where
every state line lies in this process, one launch of ``sharded_walk_kernel``
for the whole decode, the words walked where they lie and the ``psum`` a
step recorded (``Mesh.record_psums``); where a line spans processes, a step
launch of ``sharded_walk_step_kernel`` (``shard.WalkStepPlan``) and the
``psum`` a step, one ``all_reduce`` on a fixed buffer (``Mesh.plan_psum``),
the state and the sums left on the card.  On the CPU both are the plain
versions, ``_sharded_acs_scan_ref`` and ``_sharded_traceback_ref``, rounds of
PyTorch operations a step.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols
from ..ops.cuda import shard
from ..utils.bits import bits_to_bytes
from .mesh import Mesh

__all__ = ["state_sharded_decode", "state_sharded_decode_bits"]


def butterfly_perms(n_dev: int):
    """``ppermute`` plans for the butterfly halves.  Receiver d needs, as
    half-shard chunks of the OLD metric vector:

    * ``old_lo``: global old states ``[d*chunk, (d+1)*chunk)`` -> source
      shard ``d // 2``, half ``d % 2`` of its block;
    * ``old_hi``: global old states ``[S/2 + d*chunk, S/2 + (d+1)*chunk)``
      -> source shard ``(n + d) // 2``, half ``(n + d) % 2``.

    One ppermute per (target chunk, source half) pair; shards missing from a
    permutation receive zeros, so the two halves sum cleanly."""

    def _half_perm(src, half_sel, which):
        return [(src(t), t) for t in range(n_dev) if half_sel(t) == which]

    perm_lo = [_half_perm(lambda t: t // 2, lambda t: t % 2, w) for w in (0, 1)]
    perm_hi = [_half_perm(lambda t: (n_dev + t) // 2, lambda t: (n_dev + t) % 2, w)
               for w in (0, 1)]
    return perm_lo, perm_hi


def _exchange(mesh: Mesh, m_local: torch.Tensor, chunk: int, state_axis: str, perm_lo, perm_hi):
    """Old metrics ``[n, B, n_local]`` -> ``(old_lo, old_hi)`` each
    ``[n, B, chunk]`` for the local s2 range (four half-shard ppermutes)."""
    halves = (m_local[..., :chunk], m_local[..., chunk:])
    lo = (mesh.ppermute(halves[0], state_axis, perm_lo[0])
          + mesh.ppermute(halves[1], state_axis, perm_lo[1]))
    hi = (mesh.ppermute(halves[0], state_axis, perm_hi[0])
          + mesh.ppermute(halves[1], state_axis, perm_hi[1]))
    return lo, hi


def _parity_of(x: torch.Tensor) -> torch.Tensor:
    """Bitwise parity of int32 values (XOR fold)."""
    for shift in (16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


def _parity_index(code: CodeSpec, s2_block: torch.Tensor) -> torch.Tensor:
    """``[..., chunk]`` int64: bit r = ``parity(s2 & (poly_r >> 1))``, the
    part of output r's expected bit that varies across the block."""
    idx = torch.zeros_like(s2_block, dtype=torch.int64)
    for r, p in enumerate(code.abs_polys()):
        idx |= _parity_of(s2_block & (p >> 1)).to(torch.int64) << r
    return idx


def _pattern_offsets(code: CodeSpec) -> dict[tuple[int, int], int]:
    """For each (h, b): the expected-bit pattern's constant part, ``bit r =
    (b & p) ^ (h & p >> (K-1)) ^ inverted``."""
    K = code.K
    return {(h, b): sum((((b & p & 1) ^ (h & (p >> (K - 1)) & 1) ^ int(inv)) << r)
                        for r, (p, inv) in enumerate(zip(code.abs_polys(), code.inversions())))
            for h in (0, 1) for b in (0, 1)}


def _symbol_tables(code: CodeSpec, numeric: NumericSpec, sym: torch.Tensor) -> torch.Tensor:
    """``sym [..., R]`` -> ``[..., 2^R]`` int32: the branch penalty of each
    expected-bit pattern, ``sum_r (e_r ? high - y_r : y_r - low)``."""
    R = code.R
    pat = torch.arange(1 << R, device=sym.device)
    e = ((pat[:, None] >> torch.arange(R, device=sym.device)) & 1).bool()  # [2^R, R]
    y = sym.to(torch.int32)[..., None, :]
    return torch.where(e, numeric.soft_high - y, y - numeric.soft_low).sum(-1, dtype=torch.int32)


def _local_penalties(code: CodeSpec, table_t: torch.Tensor, pidx: torch.Tensor):
    """Branch penalties for the local predecessor block.

    table_t: ``[n, B, 2^R]`` (``_symbol_tables`` of one step); pidx:
    ``[n, chunk]`` (``_parity_index``).  Returns ``pen[(h, b)]`` of shape
    ``[n, B, chunk]``."""
    n, B, _ = table_t.shape
    chunk = pidx.shape[-1]
    by_offset = {}
    pens = {}
    for hb, c in _pattern_offsets(code).items():
        if c not in by_offset:
            idx = (pidx ^ c)[:, None, :].expand(n, B, chunk)
            by_offset[c] = torch.gather(table_t, 2, idx)
        pens[hb] = by_offset[c]
    return pens


@functools.lru_cache(maxsize=None)
def _byte_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def _pack_words(dec: torch.Tensor) -> torch.Tensor:
    """bool ``[..., L]`` -> int32 words ``[..., ceil(L/32)]``, bit ``i % 32``
    of word ``i // 32`` for element ``i`` (little-endian bytes viewed as
    words)."""
    L = dec.shape[-1]
    d = dec.to(torch.uint8)
    if L % 32:
        d = torch.nn.functional.pad(d, (0, 32 - L % 32))
    by = (d.reshape(*d.shape[:-1], -1, 8) << _byte_shifts(d.device)).sum(-1, dtype=torch.uint8)
    return by.view(torch.int32)


def _on_kernel(device: torch.device) -> bool:
    """The route of ``_sharded_acs_scan``: the kernel where its launcher
    takes the tensors (``shard._card``: a CUDA device)."""
    return shard._card(device)


def _current(device: torch.device):
    """``device`` made current around a plan's launches (a CUDA device)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _plan_scan(mesh: Mesh, code: CodeSpec, numeric: NumericSpec, m_local0: torch.Tensor,
               sym: torch.Tensor, state_axis: str, record: bool, half_major: bool):
    """The card route's plan of a scan: ``(plan, exchanges, halves, dec)``.
    ``halves [2, n, 2, B, chunk]`` the ping-pong metrics by half, ``m_local0``
    in buffer 1: contiguous buffers, half-major where ``half_major``, else
    interleaved ``[2, n, B, 2 chunk]`` viewed by half.  Step ``t`` runs
    ``exchanges[t % 2]`` (each target's halves of buffer ``(t + 1) % 2``, in
    place or received) and then ``plan.step(t, t % 2)``, which writes buffer
    ``t % 2`` and ``dec[t]``."""
    n_dev = mesh.shape[state_axis]
    chunk = code.num_states // (2 * n_dev)
    n, B, n_local = m_local0.shape
    T = sym.shape[2]
    perm_lo, perm_hi = butterfly_perms(n_dev)
    tables = _symbol_tables(code, numeric, sym).contiguous()  # [n, B, T, 2^R]
    dec = (torch.empty((T, n, B, -(-n_local // 32)), dtype=torch.int32, device=m_local0.device)
           if record else None)
    if half_major:
        halves = torch.empty((2, n, 2, B, chunk), dtype=torch.int32, device=m_local0.device)
    else:
        halves = torch.empty((2, n, B, 2, chunk), dtype=torch.int32,
                             device=m_local0.device).transpose(2, 3)
    halves[1].copy_(m_local0.reshape(n, B, 2, chunk).transpose(1, 2))
    # Each target receives its low half from one of two moves, its high half from one of two.
    exchanges = mesh.plan_exchange(state_axis, (perm_lo[0], perm_lo[1], perm_hi[0], perm_hi[1]),
                                   [[halves[1 - p, :, h] for h in (0, 1, 0, 1)] for p in (0, 1)])
    sources = []
    for p, ex in enumerate(exchanges):
        lo0, lo1, hi0, hi1 = ex.placed
        sources.append(([a if a is not None else b for a, b in zip(lo0, lo1)],
                        [a if a is not None else b for a, b in zip(hi0, hi1)], halves[p]))
    s2_base = [c * chunk for c in mesh.axis_coords(state_axis)]
    return shard.StepPlan(code, sources, s2_base, tables, dec), exchanges, halves, dec


def _sharded_acs_scan(mesh: Mesh, code: CodeSpec, numeric: NumericSpec, m_local0: torch.Tensor,
                      sym: torch.Tensor, state_axis: str, pidx: torch.Tensor, record: bool):
    """State-sharded ACS over ``sym [n, B, T, R]`` (each shard's symbols)
    from local metrics ``m_local0 [n, B, n_local]``.  Returns ``(metrics,
    dec)``, ``dec`` the packed decisions ``[T, n, B, ceil(n_local/32)]``
    int32 if ``record`` else ``None``.  On a CUDA device one kernel launch a
    step (``pidx`` is then computed in the kernel), planned once: the metric
    buffers half-major where the mesh spans processes (``_scan_on_card``);
    on the CPU the plain version."""
    if not _on_kernel(m_local0.device):
        return _sharded_acs_scan_ref(mesh, code, numeric, m_local0, sym, state_axis, pidx, record)
    return _scan_on_card(mesh, code, numeric, m_local0, sym, state_axis, record, mesh.world > 1)


def _scan_on_card(mesh: Mesh, code: CodeSpec, numeric: NumericSpec, m_local0: torch.Tensor,
                  sym: torch.Tensor, state_axis: str, record: bool, half_major: bool):
    """The card route of ``_sharded_acs_scan`` on the plan of ``_plan_scan``:
    a step, the exchange's run and one launcher call."""
    plan, exchanges, halves, dec = _plan_scan(mesh, code, numeric, m_local0, sym, state_axis,
                                              record, half_major)
    T = sym.shape[2]
    with _current(m_local0.device):
        for t in range(T):
            exchanges[t % 2].run()
            plan.step(t, t % 2)
    return halves[(T - 1) % 2].transpose(1, 2).reshape(m_local0.shape), dec


def _sharded_acs_scan_ref(mesh: Mesh, code: CodeSpec, numeric: NumericSpec,
                          m_local0: torch.Tensor, sym: torch.Tensor, state_axis: str,
                          pidx: torch.Tensor, record: bool):
    """The plain version of ``_sharded_acs_scan``: per step the four
    half-shard ``ppermute``s, the penalties gathered by ``pidx``, the
    select and the packing, in PyTorch operations."""
    n_dev = mesh.shape[state_axis]
    S = code.num_states
    chunk = S // (2 * n_dev)
    n, B, n_local = m_local0.shape
    T = sym.shape[2]
    perm_lo, perm_hi = butterfly_perms(n_dev)
    tables = _symbol_tables(code, numeric, sym)  # [n, B, T, 2^R]
    dec = (torch.empty((T, n, B, -(-n_local // 32)), dtype=torch.int32, device=m_local0.device)
           if record else None)
    m = m_local0
    for t in range(T):
        old_lo, old_hi = _exchange(mesh, m, chunk, state_axis, perm_lo, perm_hi)
        pens = _local_penalties(code, tables[:, :, t], pidx)
        cands, decs = [], []
        for b in (0, 1):
            c_lo = old_lo + pens[(0, b)]
            c_hi = old_hi + pens[(1, b)]
            dsel = c_hi < c_lo
            cands.append(torch.where(dsel, c_hi, c_lo))
            decs.append(dsel)
        m = torch.stack(cands, dim=-1).reshape(n, B, n_local)
        if record:
            dec[t] = _pack_words(torch.stack(decs, dim=-1).reshape(n, B, n_local))
    return m, dec


def _walk_on_kernel(device: torch.device) -> bool:
    """The route of ``_sharded_traceback``: the walk kernels on a CUDA device
    (a predicate of its own, so that each route can be pinned alone)."""
    return device.type == "cuda"


def _sharded_traceback(mesh: Mesh, code: CodeSpec, dec: torch.Tensor, end: torch.Tensor,
                       base: torch.Tensor, n_local: int, state_axis: str) -> torch.Tensor:
    """Serial traceback over the state-sharded packed decisions ``[T, n, B,
    W]`` from end states ``[n, B]`` (alike along a state line).  Returns bits
    ``[n, B, T]`` uint8.  On the CPU the plain version; on a CUDA device
    where every state line lies in this process, one launch of the walk
    kernel for the whole traceback, the JAX module's ``psum`` a step
    recorded and issued by none; where a line spans processes, a step
    kernel and the ``psum`` a step (``_walk_steps``)."""
    if not _walk_on_kernel(dec.device):
        return _sharded_traceback_ref(mesh, code, dec, end, base, n_local, state_axis)
    lines = mesh.lines_in_process(state_axis)
    if lines is None:
        return _walk_steps(mesh, code, dec, end, n_local, state_axis)
    end = end.to(torch.int32).contiguous()
    bits = shard.sharded_walk(code, dec, end, lines, n_local)
    mesh.record_psums(end, state_axis, dec.shape[0])
    return bits


def _walk_steps(mesh: Mesh, code: CodeSpec, dec: torch.Tensor, end: torch.Tensor, n_local: int,
                state_axis: str) -> torch.Tensor:
    """The traceback a step at a time, for state lines that span processes:
    one launch of the step kernel (the state update from the previous
    step's sum, the owner test, the word and the bit, the previous bit into
    the output) and one ``psum`` of ``[B]`` int32 a step, planned once: the
    i-th step writes its bits to buffer ``i % 2``, whose planned ``psum`` the
    next step reads.  The state and the sums stay on the card: nothing
    waits for the host."""
    T, n, B, _ = dec.shape
    state = end.to(torch.int32, copy=True).contiguous()
    bits = torch.empty((n, B, T), dtype=torch.uint8, device=dec.device)
    outs = torch.empty((2, n, B), dtype=torch.int32, device=dec.device)
    sums = [mesh.plan_psum(outs[i], state_axis) for i in (0, 1)]
    plan = shard.WalkStepPlan(code, dec, state, mesh.axis_coords(state_axis), n_local, bits,
                              list(outs), [r.out for r in sums])
    with _current(dec.device):
        for i, t in enumerate(range(T - 1, -1, -1)):
            plan.step(t, None if i == 0 else (i - 1) % 2, i % 2)
            sums[i % 2].run()
    bits[:, :, 0] = sums[(T - 1) % 2].out
    return bits


def _sharded_traceback_ref(mesh: Mesh, code: CodeSpec, dec: torch.Tensor, end: torch.Tensor,
                           base: torch.Tensor, n_local: int, state_axis: str) -> torch.Tensor:
    """The plain version of ``_sharded_traceback``: each step the owner's
    bit is gathered and summed over the shards with one ``psum`` of ``[B]``
    int32, in PyTorch operations.  Returns bits ``[n, B, T]`` uint8."""
    K = code.K
    T = dec.shape[0]
    state = end.to(torch.int32)
    ks = []
    for t in range(T - 1, -1, -1):
        local = state - base[:, None]
        own = (local >= 0) & (local < n_local)
        li = local.clamp(0, n_local - 1)
        word = torch.gather(dec[t], 2, (li >> 5).to(torch.int64)[..., None])[..., 0]
        bit = torch.where(own, (word >> (li & 31)) & 1, torch.zeros_like(word))
        k = mesh.psum(bit, state_axis)
        state = (state >> 1) | (k << (K - 2))
        ks.append(k)
    return torch.stack(ks[::-1], dim=-1).to(torch.uint8)


def _check_state_axis(S: int, n_dev: int) -> None:
    # The JAX module's check, precedence and all (``A or B and C``).
    if S % (2 * n_dev) != 0 or n_dev % 2 != 0 and n_dev != 1:
        raise ValueError(f"device count {n_dev} incompatible with S={S}")


def _shard_geometry(code: CodeSpec, mesh: Mesh, state_axis: str):
    """``(base [n] int32, s2 block [n, chunk] int32, n_local)`` of the local shards."""
    n_dev = mesh.shape[state_axis]
    n_local = code.num_states // n_dev
    chunk = code.num_states // (2 * n_dev)
    base = mesh.axis_index(state_axis) * n_local
    s2_block = torch.arange(chunk, dtype=torch.int32, device=mesh.device)[None] + (base // 2)[:, None]
    return base, s2_block, n_local


def _bias_metrics(code: CodeSpec, numeric: NumericSpec, mesh: Mesh, base: torch.Tensor, B: int,
                  n_local: int) -> torch.Tensor:
    """The known-start bias, sharded: ``initial_margin`` everywhere but
    global state 0 (local index 0 of state shard 0)."""
    m = torch.full((mesh.n_local, B, n_local), numeric.initial_margin, dtype=torch.int32,
                   device=mesh.device)
    m[:, :, 0] -= numeric.initial_margin * (base == 0).to(torch.int32)[:, None]
    return m


def state_sharded_decode_bits(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    mesh: Mesh,
    state_axis: str = "state",
) -> torch.Tensor:
    """Decode ``[B, T, R]`` frames with the trellis state axis sharded over
    ``mesh[state_axis]``.  Returns trellis bits ``[B, T]`` uint8.

    Requires ``num_states % (2 * n_dev) == 0``.  The traceback issues one
    ``psum`` a trellis step, O(T) collectives: the right trade for ICE's
    8-byte frames (T = 87); a long K=24 stream decodes on the composed
    state x time mesh (``parallel/state_time.py``).
    """
    n_dev = mesh.shape[state_axis]
    S = code.num_states
    _check_state_axis(S, n_dev)
    sym = mesh.shard(as_symbols(symbols, mesh.device), ())  # replicated [n, B, T, R]
    B = sym.shape[1]
    base, s2_block, n_local = _shard_geometry(code, mesh, state_axis)
    m0 = _bias_metrics(code, numeric, mesh, base, B, n_local)
    _, dec = _sharded_acs_scan(mesh, code, numeric, m0, sym, state_axis,
                               _parity_index(code, s2_block), True)
    end = torch.zeros((mesh.n_local, B), dtype=torch.int32, device=mesh.device)  # tail-terminated
    bits = _sharded_traceback(mesh, code, dec, end, base, n_local, state_axis)
    return bits[0]


def state_sharded_decode(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    mesh: Mesh,
    state_axis: str = "state",
) -> torch.Tensor:
    """State-sharded decode to bytes ``[B, num_data_bits // 8]`` uint8."""
    bits = state_sharded_decode_bits(code, numeric, symbols, mesh, state_axis)
    return bits_to_bytes(bits[:, code.K - 1 : code.K - 1 + num_data_bits])
