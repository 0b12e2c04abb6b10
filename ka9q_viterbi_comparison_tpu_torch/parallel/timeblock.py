"""Time-block (sequence) parallel decoding over a mesh.

Port of ``ka9q_viterbi_comparison_tpu/parallel/timeblock.py``.  A long
symbol stream is split into contiguous time blocks, one a shard along the
``time`` axis, and each block is decoded with the truncated-Viterbi
property: after some 5-8 K warm-up steps the survivor decisions no longer
depend on the unknown entry state.  Per shard:

1. halo exchange (``ppermute`` along ``time``): the last ``overlap`` symbol
   groups of the left neighbour's block and the first ``overlap`` of the
   right neighbour's;
2. warm-up: a metrics-only ACS over the left halo from uniform metrics;
   block 0 takes ``acs.init_metrics`` (the known start state) instead;
3. main ACS over core + right halo, decisions recorded;
4. traceback from the best end state after the right halo (first index on
   ties, ``torch.argmin``); the last block walks from state 0 at its true
   end, its halo decisions zeroed so that the walk idles at state 0;
5. the core block's bits are kept; the halo's are dropped.

Within a process, the blocks are independent once the halos have arrived,
so all local shards fold into the batch of one call: the warm-up and the
main ACS are ``ops/cuda/dispatch.acs_update`` (the in-place pair at a
folded batch of 128 or more for 5 < K <= 15, the state-order pair below),
the walk ``dispatch.walk_bits`` with the route's traceback kernel
(``chainback_inplace`` at ``t0 = 0`` for position-packed words,
``chainback_tb`` for canonical words).  On the CPU each takes its plain
version.

Above K=15 the main ACS takes the large-K plan, which subtracts a
renormalisation offset from the metrics it returns: the decisions and the
end state's ``argmin`` are unchanged by it, and the walk is
``chainback_tb`` over the words where they lie.  The JAX module runs ``acs.acs_update`` for every
K; this path is meant for K <= 15.
"""

from __future__ import annotations

import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols
from ..ops import acs
from ..ops.cuda import dispatch, inplace, kernels
from ..utils.bits import bits_to_bytes
from .mesh import Mesh

__all__ = ["default_overlap", "time_block_decode_bits", "time_block_decode"]


def default_overlap(code: CodeSpec) -> int:
    """Truncated-traceback convergence depth: ~8x constraint length."""
    return 8 * code.K


def _walk_bits(code: CodeSpec, words: torch.Tensor, end: torch.Tensor, rotated: bool):
    """Walk outputs ``[N, n]`` uint8 over batch-major words ``[N, n, W]``
    from end states ``[N]``: the route's traceback kernel over the words
    where they lie (position-packed words: ``chainback_inplace`` at ``t0 =
    0``; else ``chainback_tb``, any K up to 24)."""
    N, n, _ = words.shape
    walk = inplace.chainback_inplace if rotated else kernels.chainback_tb
    return dispatch.walk_bits(code, walk, words.to(torch.int32).permute(1, 2, 0), n, end)


def _time_block_shards(code: CodeSpec, numeric: NumericSpec, mesh: Mesh, sym_blk: torch.Tensor,
                       overlap: int, time_axis: str) -> torch.Tensor:
    """The shard body: local blocks ``[n, b, Tb, R]`` -> bits ``[n, b, Tb]``."""
    n_time = mesh.shape[time_axis]
    n, b, Tb, R = sym_blk.shape
    OL = overlap
    if Tb <= OL:
        raise ValueError(f"block size {Tb} must exceed overlap {OL}")
    fwd = [(i, i + 1) for i in range(n_time - 1)]
    bwd = [(i + 1, i) for i in range(n_time - 1)]
    # Edges receive zeros, unused.
    left = mesh.ppermute(sym_blk[:, :, -OL:], time_axis, fwd)
    right = mesh.ppermute(sym_blk[:, :, :OL], time_axis, bwd)

    N = n * b
    dev = sym_blk.device
    t_idx = mesh.axis_index(time_axis).repeat_interleave(b)  # [N]
    first, last = t_idx == 0, t_idx == n_time - 1
    m_unif = torch.zeros((N, code.num_states), dtype=torch.int32, device=dev)
    m_warm, _, _ = dispatch.acs_update(code, numeric, m_unif, left.reshape(N, OL, R))
    m0 = torch.where(first[:, None], acs.init_metrics(code, numeric, N, device=dev), m_warm)

    main = torch.cat([sym_blk, right], dim=2).reshape(N, Tb + OL, R)
    rotated = dispatch.use_inplace(code, N, dev)  # the route acs_update takes at this batch
    m_end, words, _ = dispatch.acs_update(code, numeric, m0, main)
    # The last block ends at Tb, tail-terminated: zero its halo decisions (a
    # zero word is "every decision 0" in either packing).
    words = torch.where(last[:, None, None] & (torch.arange(Tb + OL, device=dev) >= Tb)[:, None],
                        torch.zeros((), dtype=words.dtype, device=dev), words)
    best = torch.argmin(m_end, dim=-1).to(torch.int32)
    end = torch.where(last, torch.zeros_like(best), best)
    bits = _walk_bits(code, words, end, rotated)
    return bits[:, :Tb].reshape(n, b, Tb)


def time_block_decode_bits(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    mesh: Mesh,
    overlap: int | None = None,
    time_axis: str = "time",
    frame_axis: str | None = "frame",
) -> torch.Tensor:
    """Decode ``symbols [B, T, R]`` with T split over ``mesh[time_axis]``
    (and the batch over ``frame_axis`` where the mesh has it).

    Returns raw trellis bits ``[B, T]`` uint8 (bit t = data bit ``t - K +
    1``).  With several processes, ``symbols`` and the result are this
    process's block.
    """
    if overlap is None:
        overlap = default_overlap(code)
    n_time = mesh.shape[time_axis]
    T = symbols.shape[1]
    if mesh.world == 1 and T % n_time != 0:
        raise ValueError(f"T={T} not divisible by time axis size {n_time}")
    fspec = frame_axis if (frame_axis and frame_axis in mesh.shape) else None
    spec = (fspec, time_axis)
    sym_blk = mesh.shard(as_symbols(symbols, mesh.device), spec)
    bits = _time_block_shards(code, numeric, mesh, sym_blk, overlap, time_axis)
    return mesh.unshard(bits, spec)


def time_block_decode(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    mesh: Mesh,
    overlap: int | None = None,
    time_axis: str = "time",
    frame_axis: str | None = "frame",
) -> torch.Tensor:
    """Sharded decode to bytes ``[B, num_data_bits // 8]`` uint8."""
    bits = time_block_decode_bits(code, numeric, symbols, mesh, overlap, time_axis, frame_axis)
    return bits_to_bytes(bits[:, code.K - 1 : code.K - 1 + num_data_bits])
