"""A mesh of named axes, and the collectives of a sharded decode.

The port's counterpart of ``jax.sharding.Mesh`` with the ``lax`` collectives
that the JAX package's ``shard_map`` bodies use (``axis_index``,
``ppermute``, ``psum``, ``pmin``, ``all_gather``).

Layout.  The mesh has named axes (``frame``, ``time``, ``state``) and
``size`` shards, numbered row-major over the axes in the order given.  A
process holds a contiguous run of them as the leading dimension of its
tensors: with one process, all shards sit on one device (``mesh.device``);
with ``torch.distributed`` initialised, rank ``r`` holds shards
``[r * n_local, (r + 1) * n_local)``.  So a sharded tensor is ``[n_local,
...]``, and ``shard``/``unshard`` convert between it and the block of a
global tensor that the process holds (with one process: the whole tensor).

Collectives.  Between shards of one process they are index and reduction
ops on the leading dimension.  Across processes, ``ppermute`` is a batch of
``torch.distributed`` point-to-point operations (``batch_isend_irecv``) and
the reductions are ``all_reduce`` over the ranks that share a reduction
group.  The backend follows the device: NCCL serves a CUDA device and gloo
the CPU, and a mesh refuses a process group of the other backend.
``ppermute_sources`` moves the same data but places nothing: each target
gets a view of its local source or the buffer a transfer filled, for a
kernel that reads its operands where they lie.

Plans.  A scan repeats one exchange and one reduction a step.
``plan_exchange`` does the host work of ``ppermute_sources`` once: the
pairs, peers and tags, the receive buffers (allocated once and filled anew
each step: NCCL orders a later receive after the kernel that read the
buffer, on the current stream), the ``P2POp`` list of each set of
operands; ``Exchange.run`` then issues one batch.  ``plan_psum`` does the
same for a ``psum`` into a fixed buffer (``Reduction``).  Each run records
what the unplanned call records.

Counting.  Every collective goes through ``_record``, which appends one
``CollectiveCall`` to each list opened by ``recording()``;
``harness.comms.collective_trace`` turns them into a report.
``record_psums`` records the ``psum``s of a kernel that does their work
inside one process and issues none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

from ..models.decoder import resolve_device

__all__ = ["Mesh", "CollectiveCall", "Exchange", "Reduction", "recording", "backend_for"]


def backend_for(device: torch.device | str) -> str:
    """The ``torch.distributed`` backend of a device: NCCL for a CUDA
    device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class CollectiveCall:
    """One collective as a process issued it."""
    prim: str            # "ppermute", "psum", "pmin", "all_gather"
    shape: tuple         # one shard's operand
    dtype: str
    payload_bytes: int   # one shard's operand in bytes
    pairs: int           # ppermute: (source, target) pairs; reductions: 1
    axes: tuple
    site: tuple          # what tells two calls of one shape apart (the permutation)


_RECORDERS: list[list[CollectiveCall]] = []


@contextlib.contextmanager
def recording():
    """Collect every collective issued inside the block, in order."""
    calls: list[CollectiveCall] = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.pop()


class Mesh:
    """Named axes over shards, the shards of this process on ``device``.

    ``axes``: a dict (or sequence of pairs) axis name -> size, row-major in
    that order, as ``Mesh(devices.reshape(sizes), names)`` is in JAX.
    ``spans_processes=False`` keeps every shard in this process even where
    ``torch.distributed`` is initialised (a one-card reference run inside a
    multi-process program).
    """

    def __init__(self, axes, device: torch.device | str = "cuda", spans_processes: bool = True):
        items = list(axes.items()) if isinstance(axes, dict) else [tuple(a) for a in axes]
        self.axis_names = tuple(str(n) for n, _ in items)
        self.shape = {str(n): int(s) for n, s in items}
        if len(self.shape) != len(items) or min(self.shape.values(), default=1) < 1:
            raise ValueError(f"bad mesh axes {items}")
        self.size = math.prod(self.shape.values())
        self.device = resolve_device(device)
        if spans_processes and dist.is_available() and dist.is_initialized():
            want = backend_for(self.device)
            if dist.get_backend() != want:
                raise RuntimeError(f"a mesh on {self.device} needs the {want} backend; the "
                                   f"process group runs {dist.get_backend()}")
            self.world, self.rank = dist.get_world_size(), dist.get_rank()
        else:
            self.world, self.rank = 1, 0
        if self.size % self.world:
            raise ValueError(f"{self.size} shards do not divide over {self.world} processes")
        self.n_local = self.size // self.world
        self.first = self.rank * self.n_local
        self._cache: dict = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, shards {self.local_shards} of {self.size})"

    # -- layout ----------------------------------------------------------------

    @property
    def local_shards(self) -> range:
        return range(self.first, self.first + self.n_local)

    def coords(self, shard: int) -> dict[str, int]:
        c = np.unravel_index(shard, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(x) for x in c)))

    def index(self, coords: dict[str, int]) -> int:
        return int(np.ravel_multi_index(tuple(coords[a] for a in self.axis_names),
                                        tuple(self.shape.values())))

    def owner(self, shard: int) -> int:
        return shard // self.n_local

    def axis_coords(self, axis: str) -> list[int]:
        """Each local shard's coordinate along ``axis`` (host integers)."""
        return [self.coords(s)[axis] for s in self.local_shards]

    def axis_index(self, axis: str) -> torch.Tensor:
        """``lax.axis_index``: ``[n_local]`` int32 on the mesh's device
        (uploaded once: a copy from host memory waits for the stream)."""
        key = ("axis_index", axis)
        if key not in self._cache:
            self._cache[key] = torch.tensor(self.axis_coords(axis), dtype=torch.int32,
                                            device=self.device)
        return self._cache[key]

    def _lines(self, axis: str) -> list[list[int]]:
        """The reduction groups of ``axis``: for each combination of the
        other axes' coordinates, the shards along ``axis`` in order."""
        key = ("lines", axis)
        if key not in self._cache:
            others = [a for a in self.axis_names if a != axis]
            lines = []
            for combo in itertools.product(*(range(self.shape[a]) for a in others)):
                c = dict(zip(others, combo))
                lines.append([self.index({**c, axis: i}) for i in range(self.shape[axis])])
            self._cache[key] = lines
        return self._cache[key]

    def _box(self, spec) -> tuple[dict[str, int], dict[str, int]]:
        """Lowest coordinate and extent of the local shards along each axis
        of ``spec``; they must cover a whole box of those coordinates."""
        axes = [a for a in spec if a is not None]
        pts = {tuple(self.coords(s)[a] for a in axes) for s in self.local_shards}
        lo = {a: min(p[i] for p in pts) for i, a in enumerate(axes)}
        ext = {a: max(p[i] for p in pts) - lo[a] + 1 for i, a in enumerate(axes)}
        if len(pts) != math.prod(ext.values()):
            raise ValueError(f"this process's shards do not form a box along {axes}")
        return lo, ext

    def shard(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This process's shards of ``x``, ``[n_local, ...]``.

        ``x`` is the block of the global tensor that this process holds (with
        one process, the whole tensor); dimension ``i`` is split over the
        mesh axis ``spec[i]`` (``None``: not split), and the shards are
        replicated over the axes ``spec`` does not name.
        """
        lo, ext = self._box(spec)
        parts = []
        for s in self.local_shards:
            c = self.coords(s)
            idx = []
            for dim, ax in enumerate(spec):
                if ax is None:
                    idx.append(slice(None))
                    continue
                n = x.shape[dim]
                if n % ext[ax]:
                    raise ValueError(f"dimension {dim} of size {n} does not split over "
                                     f"{ext[ax]} shards of axis {ax!r}")
                step = n // ext[ax]
                k = c[ax] - lo[ax]
                idx.append(slice(k * step, (k + 1) * step))
            parts.append(x[tuple(idx)])
        return torch.stack(parts)

    def unshard(self, xs: torch.Tensor, spec) -> torch.Tensor:
        """Inverse of ``shard``: this process's block of the global tensor
        from its shards ``[n_local, ...]``; over the axes ``spec`` does not
        name, the first shard of each group is read."""
        lo, ext = self._box(spec)
        shape = list(xs.shape[1:])
        for dim, ax in enumerate(spec):
            if ax is not None:
                shape[dim] *= ext[ax]
        out = torch.empty(shape, dtype=xs.dtype, device=xs.device)
        seen = set()
        for j, s in enumerate(self.local_shards):
            c = self.coords(s)
            key = tuple(c[a] for a in spec if a is not None)
            if key in seen:
                continue
            seen.add(key)
            idx = []
            for dim, ax in enumerate(spec):
                if ax is None:
                    idx.append(slice(None))
                else:
                    step = xs.shape[1 + dim]
                    k = c[ax] - lo[ax]
                    idx.append(slice(k * step, (k + 1) * step))
            out[tuple(idx)] = xs[j]
        return out

    # -- collectives -------------------------------------------------------------

    @staticmethod
    def _call(prim: str, x: torch.Tensor, pairs: int, axes: tuple, site=()) -> CollectiveCall:
        return CollectiveCall(prim, tuple(x.shape[1:]), str(x.dtype).removeprefix("torch."),
                              x[0].numel() * x.element_size(), pairs, tuple(axes), tuple(site))

    @staticmethod
    def _emit(*calls: CollectiveCall) -> None:
        for recorder in _RECORDERS:
            recorder.extend(calls)

    def _record(self, prim: str, x: torch.Tensor, pairs: int, axes: tuple, site=()) -> None:
        if _RECORDERS:
            self._emit(self._call(prim, x, pairs, axes, site))

    def _pairs(self, axis: str, perm: tuple) -> list[tuple[int, int]]:
        """``perm`` (coordinates along ``axis``) as (source, target) shard pairs,
        in one order that every process derives alike."""
        key = ("pairs", axis, perm)
        if key not in self._cache:
            self._cache[key] = [(line[s], line[d]) for line in self._lines(axis) for s, d in perm]
        return self._cache[key]

    def _local_moves(self, axis: str, perm: tuple):
        """Index tensors (target, source) of the pairs held by this process."""
        key = ("moves", axis, perm)
        if key not in self._cache:
            pairs = [(d - self.first, s - self.first) for s, d in self._pairs(axis, perm)
                     if self.owner(s) == self.rank and self.owner(d) == self.rank]
            dst = torch.tensor([d for d, _ in pairs], dtype=torch.long, device=self.device)
            src = torch.tensor([s for _, s in pairs], dtype=torch.long, device=self.device)
            self._cache[key] = (dst, src)
        return self._cache[key]

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``lax.ppermute``: shard ``(.., i, ..)`` along ``axis`` receives the
        operand of ``(.., j, ..)`` for each ``(j, i)`` in ``perm``; a shard that
        no pair targets receives zeros."""
        perm = tuple((int(s), int(d)) for s, d in perm)
        if len({d for _, d in perm}) != len(perm) or len({s for s, _ in perm}) != len(perm):
            raise ValueError(f"ppermute: {perm} is not a permutation")
        self._record("ppermute", x, len(perm), (axis,), perm)
        out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        dst, src = self._local_moves(axis, perm)
        if dst.numel():
            out[dst] = x[src]
        if self.world > 1:
            x = x.contiguous()
            ops = []
            for tag, (s, d) in enumerate(self._pairs(axis, perm)):
                so, do = self.owner(s), self.owner(d)
                if so == do:
                    continue
                if so == self.rank:
                    ops.append(dist.P2POp(dist.isend, x[s - self.first], do, tag=tag))
                elif do == self.rank:
                    ops.append(dist.P2POp(dist.irecv, out[d - self.first], so, tag=tag))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
        return out

    def ppermute_sources(self, axis: str, *moves) -> list[list[torch.Tensor | None]]:
        """``ppermute`` of each ``(x, perm)`` in ``moves``, left where the data
        lies: for each move, a list over the local shards of what the shard
        receives -- a view ``x[source]`` where the source is in this process,
        a buffer that the cross-process transfer filled where it is not, None
        where no pair targets the shard.  Each move is recorded as
        ``ppermute`` records it; the transfers of all moves go in one batch.
        The one-call form of ``plan_exchange`` (across processes a strided
        operand is copied first: NCCL sends contiguous memory)."""
        xs = [x if self.world == 1 else x.contiguous() for x, _ in moves]
        exchange, = self.plan_exchange(axis, [perm for _, perm in moves], [xs])
        exchange.run()
        return exchange.placed

    def plan_exchange(self, axis: str, perms, operand_sets) -> list["Exchange"]:
        """``ppermute_sources`` of the moves ``zip(operands, perms)`` for each
        list of operands in ``operand_sets``, planned once for repeated runs:
        one ``Exchange`` a set, whose ``placed`` lists are fixed and whose
        ``run()`` moves the operands' current contents.  The sets share the
        receive buffers (a move's operands have one shape and dtype in every
        set); an operand that this process sends from must be contiguous."""
        perms = [tuple((int(s), int(d)) for s, d in perm) for perm in perms]
        for perm in perms:
            if len({d for _, d in perm}) != len(perm) or len({s for s, _ in perm}) != len(perm):
                raise ValueError(f"ppermute: {perm} is not a permutation")
        for xs in operand_sets:
            if len(xs) != len(perms) or any(
                    (x.shape, x.dtype) != (y.shape, y.dtype) for x, y in zip(xs, operand_sets[0])):
                raise ValueError("plan_exchange: every set needs an operand of one shape and "
                                 "dtype a move")
        # A move's pairs that touch this process: (local target, or None for a send; local
        # source; peer; tag; the receive buffer where the source is remote).
        tag, routes = 0, []
        for x, perm in zip(operand_sets[0], perms):
            route = []
            for s, d in self._pairs(axis, perm):
                so, do = self.owner(s), self.owner(d)
                if do == self.rank:
                    recv = None if so == self.rank else torch.empty(x.shape[1:], dtype=x.dtype,
                                                                    device=x.device)
                    route.append((d - self.first, s - self.first, so, tag, recv))
                elif so == self.rank:
                    route.append((None, s - self.first, do, tag, None))
                tag += 1  # every process counts the pairs in one order
            routes.append(route)
        out = []
        for xs in operand_sets:
            calls = [self._call("ppermute", x, len(perm), (axis,), perm)
                     for x, perm in zip(xs, perms)]
            placed, ops = [[None] * self.n_local for _ in xs], []
            for m, (x, route) in enumerate(zip(xs, routes)):
                shards = x.unbind(0)
                for target, src, peer, tg, recv in route:
                    if target is None:  # a send
                        if not shards[src].is_contiguous():
                            raise ValueError("plan_exchange: a send reads contiguous memory; "
                                             f"the operand of move {m} is strided")
                        ops.append(dist.P2POp(dist.isend, shards[src], peer, tag=tg))
                    elif recv is None:
                        placed[m][target] = shards[src]
                    else:
                        placed[m][target] = recv
                        ops.append(dist.P2POp(dist.irecv, recv, peer, tag=tg))
            out.append(Exchange(placed, ops, calls))
        return out

    def _process_groups(self, axis: str) -> dict[tuple, object]:
        """The process group of each set of ranks that shares a reduction
        group of ``axis``.  Every process creates them all, in one order, on
        first use (``dist.new_group`` asks that of every rank)."""
        key = ("groups", axis)
        if key not in self._cache:
            ranksets = sorted({tuple(sorted({self.owner(s) for s in line}))
                               for line in self._lines(axis)})
            groups = {}
            for rs in ranksets:
                if len(rs) == 1:
                    continue
                groups[rs] = dist.group.WORLD if len(rs) == self.world else dist.new_group(list(rs))
            self._cache[key] = groups
        return self._cache[key]

    def _local_lines(self, axis: str):
        """The reduction groups of ``axis`` that hold a shard of this process:
        for each, a selector of its local shards; the group of each local
        shard; and the rows of each set of ranks that a group spans, by rank
        set.  A selector is a slice where its indices are adjacent, else an
        index tensor on the mesh's device, so that applying one copies
        nothing from the host (a copy from host memory waits for the
        stream)."""
        key = ("local_lines", axis)
        if key not in self._cache:
            lines = [ln for ln in self._lines(axis) if any(self.owner(s) == self.rank for s in ln)]
            members, rows, line_of = [], {}, [0] * self.n_local
            for i, line in enumerate(lines):
                local = [s - self.first for s in line if self.owner(s) == self.rank]
                for j in local:
                    line_of[j] = i
                members.append(self._selector(local))
                rows.setdefault(tuple(sorted({self.owner(s) for s in line})), []).append(i)
            self._cache[key] = (members, torch.tensor(line_of, dtype=torch.long, device=self.device),
                                {rs: self._selector(r) for rs, r in rows.items()})
        return self._cache[key]

    def _selector(self, idx: list[int]):
        if idx == list(range(idx[0], idx[-1] + 1)):
            return slice(idx[0], idx[-1] + 1)
        return torch.tensor(idx, dtype=torch.long, device=self.device)

    def lines_in_process(self, axis: str) -> list[list[int]] | None:
        """The reduction groups of ``axis`` that this process holds, each as
        its local shard indices in axis order, where no group of the mesh
        spans processes; None where one does (each process then takes part in
        every reduction of that group, so a reduction has to be issued)."""
        lines = self._lines(axis)
        if any(self.owner(s) != self.owner(line[0]) for line in lines for s in line):
            return None
        return [[s - self.first for s in line] for line in lines if self.owner(line[0]) == self.rank]

    def _group_rows(self, axis: str) -> list[tuple]:
        """``(rows, group)`` for each set of ranks that a reduction group of
        this process spans: the rows of the groups' local partial results
        that one ``all_reduce`` over ``group`` completes."""
        if self.world == 1:
            return []
        _, _, rows_of = self._local_lines(axis)
        return [(rows_of[rs], group) for rs, group in self._process_groups(axis).items()
                if rs in rows_of]

    @staticmethod
    def _all_reduce_rows(red: torch.Tensor, group_rows: list[tuple], op: str) -> None:
        for rows, group in group_rows:
            buf = red[rows].contiguous()  # a slice of rows of red: a view, reduced in place
            dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN,
                            group=group)
            if not isinstance(rows, slice):
                red[rows] = buf

    def _reduce(self, x: torch.Tensor, axis: str, op: str) -> torch.Tensor:
        members, line_of, _ = self._local_lines(axis)
        red = torch.stack([x[m].sum(0, dtype=x.dtype) if op == "sum" else x[m].amin(0)
                           for m in members])
        self._all_reduce_rows(red, self._group_rows(axis), op)
        return red[line_of]

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.psum`` over ``axis``: every shard of a group gets the group's sum."""
        self._record("psum", x, 1, (axis,))
        return self._reduce(x, axis, "sum")

    def plan_psum(self, x: torch.Tensor, axis: str) -> "Reduction":
        """``psum(x, axis)`` planned once for repeated runs on the fixed
        buffer ``x`` (contiguous): ``Reduction.out`` holds the sums after
        each ``run()``.  Where each reduction group holds one shard of this
        process, in order, the sums are made in place (``out`` is ``x``):
        one ``all_reduce`` a set of ranks, nothing else."""
        if not x.is_contiguous():
            raise ValueError("plan_psum: the buffer must be contiguous")
        members, line_of, _ = self._local_lines(axis)
        alone = len(members) == self.n_local and all(
            isinstance(m, slice) and (m.start, m.stop) == (j, j + 1) for j, m in enumerate(members))
        return Reduction(x, members, None if alone else line_of, self._group_rows(axis),
                         self._call("psum", x, 1, (axis,)))

    def record_psums(self, x: torch.Tensor, axis: str, steps: int) -> None:
        """Record ``steps`` calls of ``psum(x, axis)`` and issue none: the
        logical collectives of a kernel that does their work inside one
        process (as ``ppermute_sources`` records the moves it leaves in
        place)."""
        for _ in range(steps):
            self._record("psum", x, 1, (axis,))

    def pmin(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.pmin`` over ``axis``."""
        self._record("pmin", x, 1, (axis,))
        return self._reduce(x, axis, "min")

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``lax.all_gather`` over ``axis``: ``[n_local, n_axis, ...]``, the
        operands of the group's shards in axis order."""
        self._record("all_gather", x, 1, (axis,))
        placed = torch.zeros((x.shape[0], self.shape[axis], *x.shape[1:]), dtype=x.dtype,
                             device=x.device)
        key = ("coords", axis)
        if key not in self._cache:
            self._cache[key] = self.axis_index(axis).to(torch.long)
        placed[torch.arange(x.shape[0], device=x.device), self._cache[key]] = x
        return self._reduce(placed, axis, "sum")


class Exchange:
    """One planned ``ppermute_sources`` (``Mesh.plan_exchange``): ``placed``
    as ``ppermute_sources`` returns it, fixed; ``run()`` records the moves
    and issues the cross-process transfers as one batch."""

    def __init__(self, placed: list, ops: list, calls: list[CollectiveCall]):
        self.placed, self.ops, self.calls = placed, ops, calls

    def run(self) -> None:
        if _RECORDERS:
            Mesh._emit(*self.calls)
        if self.ops:
            for req in dist.batch_isend_irecv(self.ops):
                req.wait()


class Reduction:
    """One planned ``psum`` (``Mesh.plan_psum``) of the buffer ``x`` into
    ``out``: the local partial sums of each reduction group, one
    ``all_reduce`` a set of ranks (``Mesh._all_reduce_rows``, as
    ``Mesh.psum``), each shard's group sum."""

    def __init__(self, x: torch.Tensor, members: list, line_of: torch.Tensor | None,
                 group_rows: list, call: CollectiveCall):
        self.x, self.members, self.line_of, self.group_rows = x, members, line_of, group_rows
        self.call = call
        if line_of is None:
            self.red = self.out = x
        else:
            self.red = torch.empty((len(members), *x.shape[1:]), dtype=x.dtype, device=x.device)
            self.out = torch.empty_like(x)

    def run(self) -> torch.Tensor:
        if _RECORDERS:
            Mesh._emit(self.call)
        if self.line_of is not None:
            for i, m in enumerate(self.members):
                torch.sum(self.x[m], 0, dtype=self.x.dtype, out=self.red[i])
        Mesh._all_reduce_rows(self.red, self.group_rows, "sum")
        if self.line_of is not None:
            torch.index_select(self.red, 0, self.line_of, out=self.out)
        return self.out
