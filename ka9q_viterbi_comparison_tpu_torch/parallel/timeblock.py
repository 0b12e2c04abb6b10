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
so all local shards fold into the batch of one call, planned once per
(mesh, shape) and cached on the mesh (``_plan``, as ``statewise._plan_scan``
plans a scan): fixed symbol buffers in the kernels' ``[T, R, N]`` layout, the
uniform and initial entry metrics, each frame's start step, and across
processes one ``Mesh.plan_exchange`` of both halos (in one process the halos
are index ops, their ``ppermute``s recorded all the same).  On the routes of
the whole-frame kernels (the in-place pair at a folded batch of 128 or more
for 5 < K <= 15, the state-order pair below for K <= 9) a call is then the
symbols' copies, the warm-up and the main ACS, one ``where`` and one walk:
the in-place warm-up starts at phase ``-overlap mod (K-1)``, so its metrics
come back in state order; the walk takes the end state as the argmin of the
metrics itself, starts the last block from state 0 at step ``Tb`` (its
start-step form, in place of zeroing the halo's decisions) and writes the
core's ``Tb`` bits straight into the output.  On the CPU each kernel takes
its plain version.

Above K=15, and for K = 10..15 below the in-place batch, the ACS takes
``dispatch.acs_update``'s large-K plan, which subtracts a renormalisation
offset from the metrics it returns: the decisions and the end state's
argmin are unchanged by it, and the walk is ``chainback_tb`` over the words
where they lie.  The JAX module runs ``acs.acs_update`` for every K; this
path is meant for K <= 15.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols
from ..ops import acs
from ..ops.cuda import dispatch, inplace, kernels
from ..utils.bits import bits_to_bytes
from .mesh import Exchange, Mesh

__all__ = ["default_overlap", "time_block_decode_bits", "time_block_decode"]


def default_overlap(code: CodeSpec) -> int:
    """Truncated-traceback convergence depth: ~8x constraint length."""
    return 8 * code.K


def _walk_bits(code: CodeSpec, words: torch.Tensor, end, rotated: bool, **form):
    """Walk outputs over batch-major words ``[N, n, W]``: the route's
    traceback kernel over the words where they lie (position-packed words:
    ``chainback_inplace`` at ``t0 = 0``; else ``chainback_tb``, any K up to
    24), in its ``bits`` form -- ``[N, n]`` uint8 from end states ``end``
    unless ``form`` says otherwise (``lo``, ``hi``, ``out``, ``start``,
    ``metrics``)."""
    walk = inplace.chainback_inplace if rotated else kernels.chainback_tb
    extra = (0,) if rotated else ()
    return walk(code, words.to(torch.int32).permute(1, 2, 0), end, words.shape[1], *extra, "bits",
                **form)


@dataclasses.dataclass
class _Plan:
    """The fixed part of one shard body (``_plan``)."""
    route: str                # "inplace", "pair" (the state-order pair) or "large"
    exchange: Exchange
    halos: tuple              # across processes: the send buffers [n, b, OL, R], left and right
    lsrc: torch.Tensor        # in one process: the frame each frame's left halo comes from
    rsrc: torch.Tensor        # ... and its right halo (any frame where it has no neighbour)
    warm_sym: torch.Tensor    # [OL, R, N] the left halos
    main_sym: torch.Tensor    # [Tb + OL, R, N] the blocks and their right halos
    warm_words: torch.Tensor  # [OL, W, N] the warm-up's words, unread (native routes)
    main_words: torch.Tensor  # [Tb + OL, W, N]
    m_unif: torch.Tensor      # uniform entry metrics ([S, N] native, else [N, S])
    m_init: torch.Tensor      # the known start state's, same layout
    first: torch.Tensor       # [1, N] (native) or [N, 1]: the frame's block is the first
    start: torch.Tensor       # [N] int32: Tb for the last block's frames, else Tb + OL


def _plan(code: CodeSpec, numeric: NumericSpec, mesh: Mesh, shape: tuple, overlap: int,
          time_axis: str) -> _Plan:
    """The shard body's plan for local blocks of ``shape = (n, b, Tb, R)``,
    built once per (mesh, code, numeric, shape, overlap, axis, route) and
    cached on the mesh."""
    n, b, Tb, R = shape
    OL, N, dev = overlap, n * b, mesh.device
    rotated = dispatch.use_inplace(code, N, dev)  # the route acs_update takes at this batch
    key = ("timeblock", code, numeric, shape, overlap, time_axis, rotated)
    if key in mesh._cache:
        return mesh._cache[key]
    n_time = mesh.shape[time_axis]
    fwd = [(i, i + 1) for i in range(n_time - 1)]
    bwd = [(i + 1, i) for i in range(n_time - 1)]
    halos = tuple(torch.empty((n, b, OL, R), dtype=torch.int32, device=dev) for _ in range(2))
    exchange, = mesh.plan_exchange(time_axis, [fwd, bwd], [list(halos)])
    # In one process the moves' sources are local shards: as frame indices.
    src_of = [list(range(n)), list(range(n))]
    for m, perm in enumerate((fwd, bwd)):
        for s, d in mesh._pairs(time_axis, tuple(perm)):
            if mesh.owner(s) == mesh.owner(d) == mesh.rank:
                src_of[m][d - mesh.first] = s - mesh.first
    frames = lambda shards: torch.tensor(  # noqa: E731
        [j * b + f for j in shards for f in range(b)], dtype=torch.long, device=dev)
    t_idx = mesh.axis_coords(time_axis)
    first = torch.tensor([t == 0 for t in t_idx for _ in range(b)], device=dev)
    last = [t == n_time - 1 for t in t_idx for _ in range(b)]
    route = "inplace" if rotated else ("pair" if dispatch.supports(code) else "large")
    native = route != "large"
    m_init = acs.init_metrics(code, numeric, N, device=dev)
    m_unif = torch.zeros_like(m_init)
    W = code.decision_words
    plan = _Plan(
        route, exchange, halos, frames(src_of[0]), frames(src_of[1]),
        torch.empty((OL, R, N), dtype=torch.int32, device=dev),
        torch.empty((Tb + OL, R, N), dtype=torch.int32, device=dev),
        torch.empty((OL, W, N) if native else (0,), dtype=torch.int32, device=dev),
        torch.empty((Tb + OL, W, N) if native else (0,), dtype=torch.int32, device=dev),
        m_unif.T.contiguous() if native else m_unif,
        m_init.T.contiguous() if native else m_init,
        first[None, :] if native else first[:, None],
        torch.tensor([Tb if x else Tb + OL for x in last], dtype=torch.int32, device=dev))
    mesh._cache[key] = plan
    return plan


def _gather_halos(p: _Plan, mesh: Mesh, sym_blk: torch.Tensor) -> None:
    """Fill the plan's symbol buffers: the blocks, then each frame's halos
    from its neighbours (index ops in one process, one planned exchange
    across processes)."""
    n, b, Tb, R = sym_blk.shape
    OL = p.warm_sym.shape[0]
    core = p.main_sym[:Tb]
    core.copy_(sym_blk.permute(2, 3, 0, 1).reshape(Tb, R, n * b))
    if mesh.world == 1:
        p.exchange.run()  # records the two halo ppermutes; nothing crosses a process
        torch.index_select(core[Tb - OL:], 2, p.lsrc, out=p.warm_sym)
        torch.index_select(core[:OL], 2, p.rsrc, out=p.main_sym[Tb:])
        return
    p.halos[0].copy_(sym_blk[:, :, -OL:])
    p.halos[1].copy_(sym_blk[:, :, :OL])
    p.exchange.run()
    for buf, placed in ((p.warm_sym, p.exchange.placed[0]), (p.main_sym[Tb:], p.exchange.placed[1])):
        for i, got in enumerate(placed):
            if got is not None:  # an edge receives nothing and its halo is unused
                buf[:, :, i * b:(i + 1) * b].copy_(got.permute(1, 2, 0))


def _time_block_shards(code: CodeSpec, numeric: NumericSpec, mesh: Mesh, sym_blk: torch.Tensor,
                       overlap: int, time_axis: str) -> torch.Tensor:
    """The shard body: local blocks ``[n, b, Tb, R]`` -> bits ``[n, b, Tb]``."""
    n, b, Tb, R = sym_blk.shape
    OL = overlap
    if Tb <= OL:
        raise ValueError(f"block size {Tb} must exceed overlap {OL}")
    p = _plan(code, numeric, mesh, (n, b, Tb, R), OL, time_axis)
    _gather_halos(p, mesh, sym_blk)
    N, T = n * b, Tb + OL
    out = torch.empty((N, Tb), dtype=torch.uint8, device=mesh.device)
    if p.route == "large":
        m_warm, _, _ = dispatch.acs_update(code, numeric, p.m_unif, p.warm_sym.permute(2, 0, 1))
        m0 = torch.where(p.first, p.m_init, m_warm)
        m_end, words, _ = dispatch.acs_update(code, numeric, m0, p.main_sym.permute(2, 0, 1))
        _walk_bits(code, words, None, False, hi=Tb, out=out, start=p.start, metrics=m_end.T)
        return out.reshape(n, b, Tb)
    if p.route == "inplace":
        nrot = code.K - 1
        # From phase -OL the warm-up's metrics come back in state order (phase 0).
        m_warm, _ = inplace.acs_update_inplace(code, numeric, p.m_unif, p.warm_sym, OL,
                                               -OL % nrot, out=p.warm_words)
        m0 = torch.where(p.first, p.m_init, m_warm)
        m_end, _ = inplace.acs_update_inplace(code, numeric, m0, p.main_sym, T, 0,
                                              out=p.main_words)
        inplace.chainback_inplace(code, p.main_words, None, T, 0, form="bits", hi=Tb, out=out,
                                  start=p.start, metrics=m_end, metrics_phase=T % nrot)
    else:
        update = dispatch._small_k_impl(N)
        m_warm, _ = update(code, numeric, p.m_unif, p.warm_sym, OL, out=p.warm_words)
        m0 = torch.where(p.first, p.m_init, m_warm)
        m_end, _ = update(code, numeric, m0, p.main_sym, T, out=p.main_words)
        kernels.chainback_tb(code, p.main_words, None, T, "bits", 0, Tb, out=out, start=p.start,
                             metrics=m_end)
    return out.reshape(n, b, Tb)


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
