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

The JAX module's scan is ``jnp`` with no Pallas kernel behind it.  Here the
scan takes its route by device (``_on_kernel``): on a CUDA device one launch
a step of ``sharded_acs_step_kernel`` (``ops/cuda/shard.py``) for every
local shard and frame, each target's old metrics read where the exchange
left them (``Mesh.ppermute_sources``: halves of the local shards in place,
buffers that NCCL filled across processes), the penalty index computed in
the kernel; on the CPU the plain version ``_sharded_acs_scan_ref``, a round
of PyTorch operations a step.  The traceback is PyTorch operations either
way.
"""

from __future__ import annotations

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
    """The route of ``_sharded_acs_scan``: the kernel on a CUDA device."""
    return device.type == "cuda"


def _sharded_acs_scan(mesh: Mesh, code: CodeSpec, numeric: NumericSpec, m_local0: torch.Tensor,
                      sym: torch.Tensor, state_axis: str, pidx: torch.Tensor, record: bool):
    """State-sharded ACS over ``sym [n, B, T, R]`` (each shard's symbols)
    from local metrics ``m_local0 [n, B, n_local]``.  Returns ``(metrics,
    dec)``, ``dec`` the packed decisions ``[T, n, B, ceil(n_local/32)]``
    int32 if ``record`` else ``None``.  On a CUDA device one kernel launch a
    step (``pidx`` is then computed in the kernel); on the CPU the plain
    version."""
    if not _on_kernel(m_local0.device):
        return _sharded_acs_scan_ref(mesh, code, numeric, m_local0, sym, state_axis, pidx, record)
    n_dev = mesh.shape[state_axis]
    chunk = code.num_states // (2 * n_dev)
    n, B, n_local = m_local0.shape
    T = sym.shape[2]
    perm_lo, perm_hi = butterfly_perms(n_dev)
    tables = _symbol_tables(code, numeric, sym).contiguous()  # [n, B, T, 2^R]
    dec = (torch.empty((T, n, B, -(-n_local // 32)), dtype=torch.int32, device=m_local0.device)
           if record else None)
    s2_base = [c * chunk for c in mesh.axis_coords(state_axis)]
    m = m_local0.contiguous()
    bufs = (torch.empty_like(m), torch.empty_like(m))
    for t in range(T):
        halves = (m[..., :chunk], m[..., chunk:])
        lo0, lo1, hi0, hi1 = mesh.ppermute_sources(
            state_axis, (halves[0], perm_lo[0]), (halves[1], perm_lo[1]),
            (halves[0], perm_hi[0]), (halves[1], perm_hi[1]))
        # Each target receives its low half from one of two moves, its high from one of two.
        lo = [a if a is not None else b for a, b in zip(lo0, lo1)]
        hi = [a if a is not None else b for a, b in zip(hi0, hi1)]
        shard.sharded_acs_step(code, lo, hi, s2_base, tables, t, bufs[t % 2],
                               dec[t] if record else None)
        m = bufs[t % 2]
    return m, dec


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


def _sharded_traceback(mesh: Mesh, code: CodeSpec, dec: torch.Tensor, end: torch.Tensor,
                       base: torch.Tensor, n_local: int, state_axis: str) -> torch.Tensor:
    """Serial traceback over the state-sharded packed decisions ``[T, n, B,
    W]`` from end states ``[n, B]``; each step the owner's bit is gathered
    and summed over the shards with one ``psum`` of ``[B]`` int32.  Returns
    bits ``[n, B, T]`` uint8."""
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
