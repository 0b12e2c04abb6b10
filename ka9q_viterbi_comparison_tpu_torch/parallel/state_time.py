"""Composed state x time mesh decoding for long large-K streams.

Port of ``ka9q_viterbi_comparison_tpu/parallel/state_time.py``.  Every time
block runs the state-sharded butterfly-exchange ACS of ``statewise.py``
(metrics split over ``state``), and every traceback stays inside one time
block (halo-converged, as in ``timeblock.py``), so blocks never wait on one
another.  A trellis step exchanges the same four half-shard ``ppermute``s as
pure state sharding; the ``time`` axis adds the one-shot symbol halos, and
each block's traceback its ``psum`` a step.

Each block warms up from uniform metrics over the left neighbour's last
``overlap`` symbol groups; block 0 takes the known-start bias instead.
Non-final blocks walk from the global best end state: the ``pmin`` of the
shards' minima, then the ``pmin`` of the candidates' global indices, so
ties go to the first index as ``torch.argmin`` over the whole vector would.
The final block walks from state 0 (tail-terminated).

K=24 frames have odd T (8n + 23), so an even time split needs padding:
``pad_to_time_blocks`` appends the state-0 self-loop's exact rail symbols,
under which the tail-terminated path idles at state 0.
"""

from __future__ import annotations

import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols
from ..utils.bits import bits_to_bytes
from .mesh import Mesh
from .statewise import (_bias_metrics, _parity_index, _shard_geometry, _sharded_acs_scan,
                        _sharded_traceback)
from .timeblock import default_overlap

__all__ = ["pad_to_time_blocks", "state_time_decode", "state_time_decode_bits"]


def pad_to_time_blocks(code: CodeSpec, numeric: NumericSpec, symbols: torch.Tensor,
                       multiple: int) -> tuple[torch.Tensor, int]:
    """Pad ``symbols [B, T, R]`` to ``T % multiple == 0`` with the encoded
    zero-input groups of the state-0 self-loop (expected bit 0 but for an
    inverted polynomial).  Returns ``(padded_symbols, pad)``."""
    B, T, R = symbols.shape
    pad = (-T) % multiple
    if pad == 0:
        return symbols, 0
    vals = torch.tensor([numeric.soft_high if inv else numeric.soft_low
                         for inv in code.inversions()], dtype=symbols.dtype, device=symbols.device)
    return torch.cat([symbols, vals.expand(B, pad, R)], dim=1), pad


def _global_best(mesh: Mesh, m_end: torch.Tensor, base: torch.Tensor, state_axis: str,
                 S: int) -> torch.Tensor:
    """First index of the global minimum over the state shards: ``[n, B]``
    int32 from the local metrics ``[n, B, n_local]``."""
    local_min = m_end.amin(dim=-1)
    g_min = mesh.pmin(local_min, state_axis)
    local_arg = torch.argmin(m_end, dim=-1).to(torch.int32) + base[:, None]
    cand = torch.where(local_min == g_min, local_arg, torch.full_like(local_arg, S))
    return mesh.pmin(cand, state_axis)


def state_time_decode_bits(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    mesh: Mesh,
    overlap: int | None = None,
    time_axis: str = "time",
    state_axis: str = "state",
) -> torch.Tensor:
    """Decode ``[B, T, R]`` frames on a composed ``(state, time)`` mesh:
    trellis bits ``[B, T]`` uint8.

    Requires ``T % mesh.shape[time_axis] == 0`` (see ``pad_to_time_blocks``)
    and a block size exceeding ``overlap``.
    """
    if overlap is None:
        overlap = default_overlap(code)
    n_time = mesh.shape[time_axis]
    n_state = mesh.shape[state_axis]
    S = code.num_states
    if S % (2 * n_state) != 0 or (n_state % 2 != 0 and n_state != 1):
        raise ValueError(f"state axis size {n_state} incompatible with S={S}")
    T = symbols.shape[1]
    if mesh.world == 1 and T % n_time != 0:
        raise ValueError(f"T={T} not divisible by time axis size {n_time}; "
                         "pad with pad_to_time_blocks")
    spec = (None, time_axis)
    sym_blk = mesh.shard(as_symbols(symbols, mesh.device), spec)  # [n, B, Tb, R]
    n, B, Tb, R = sym_blk.shape
    OL = overlap
    if Tb <= OL:
        raise ValueError(f"block size {Tb} must exceed overlap {OL}")
    base, s2_block, n_local = _shard_geometry(code, mesh, state_axis)
    pidx = _parity_index(code, s2_block)
    dev = mesh.device

    fwd = [(i, i + 1) for i in range(n_time - 1)]
    bwd = [(i + 1, i) for i in range(n_time - 1)]
    left = mesh.ppermute(sym_blk[:, :, -OL:], time_axis, fwd)
    right = mesh.ppermute(sym_blk[:, :, :OL], time_axis, bwd)

    m_unif = torch.zeros((n, B, n_local), dtype=torch.int32, device=dev)
    m_warm, _ = _sharded_acs_scan(mesh, code, numeric, m_unif, left, state_axis, pidx, False)
    t_idx = mesh.axis_index(time_axis)
    m_bias = _bias_metrics(code, numeric, mesh, base, B, n_local)
    m0 = torch.where((t_idx == 0)[:, None, None], m_bias, m_warm)

    main = torch.cat([sym_blk, right], dim=2)  # [n, B, Tb + OL, R]
    m_end, dec = _sharded_acs_scan(mesh, code, numeric, m0, main, state_axis, pidx, True)
    last = t_idx == n_time - 1
    # Last block: true end at Tb, state 0; zero its halo decisions.
    dec[Tb:, last] = 0

    best = _global_best(mesh, m_end, base, state_axis, S)
    end = torch.where(last[:, None], torch.zeros_like(best), best)
    bits = _sharded_traceback(mesh, code, dec, end, base, n_local, state_axis)
    return mesh.unshard(bits[:, :, :Tb], spec)


def state_time_decode(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    mesh: Mesh,
    overlap: int | None = None,
    time_axis: str = "time",
    state_axis: str = "state",
) -> torch.Tensor:
    """Composed-mesh decode to bytes ``[B, num_data_bits // 8]`` uint8;
    ``symbols`` are padded to the time-axis multiple here."""
    symbols, _ = pad_to_time_blocks(code, numeric, as_symbols(symbols, mesh.device),
                                    mesh.shape[time_axis])
    bits = state_time_decode_bits(code, numeric, symbols, mesh, overlap, time_axis, state_axis)
    return bits_to_bytes(bits[:, code.K - 1 : code.K - 1 + num_data_bits])
