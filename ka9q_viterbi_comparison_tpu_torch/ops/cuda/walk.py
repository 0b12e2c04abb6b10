"""The table walk above K=15 on the card.

The JAX package walks large trellises in ``jnp`` (``ops/radix_planes.py``
``chainback_plane_bits`` over the f8/f4 tables), so this kernel replaces no
Pallas kernel; it takes the port's table walk off the host, where each
window was a round of PyTorch launches.  ``plane_walk_kernel``
(``csrc/viterbi_walk.cu``; counter ``chainback_planes``): a thread a frame
walks the windows of ``radix_planes.plane_plan``, one fetch a width-8 or
width-4 window, and writes the kept bits, or the bytes MSB-first, itself.
Its plain version is ``radix_planes.chainback_plane_bits``.  (The canonical
words of the large-K updates walk on ``kernels.chainback_tb``, which takes
any K up to 24.)

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from ...configs import CodeSpec
from .. import radix_planes as rp
from . import _build

__all__ = ["chainback_planes", "chainback_plane_bits", "chainback_planes_ref"]

_END_SCALAR, _END_INT32, _END_UINT8 = 0, 1, 2


def _end_args(endstate, B: int, device: torch.device) -> tuple:
    """``(pointer, kind, stride, value, keep-alive)`` of an end state: an int,
    or a 0-d, ``[B]`` or ``[1, B]`` int32 or uint8 tensor on the device, read
    by the kernel where it lies (no launch converts it)."""
    if not isinstance(endstate, torch.Tensor):
        return None, _END_SCALAR, 0, int(endstate), None
    end = endstate.to(device)
    if end.dtype not in (torch.int32, torch.uint8):
        end = end.to(torch.int32)
    if end.numel() not in (1, B):
        raise ValueError(f"endstate: expected 1 or {B} values, got shape {tuple(end.shape)}")
    end = end.reshape(-1).contiguous()
    kind = _END_INT32 if end.dtype == torch.int32 else _END_UINT8
    return end.data_ptr(), kind, 1 if end.numel() == B else 0, 0, end


def _check_plan(tables: dict, words, T: int, anchor: int, maxw: int) -> None:
    """Every table row the walk of ``plane_plan(T, anchor, maxw)`` reads
    exists: ``T - anchor`` steps are full windows, then (from the top) one
    window each of width 4, 2 and 1 for the bits of the remainder."""
    nsteps = max(T - anchor, 0)
    full, r = divmod(nsteps, maxw)
    need = {f"f{maxw}": full}
    if maxw == 8 and r & 4:
        need["f4"] = 2 * full + 1
    if r & 2:
        need["g2"] = (maxw * full + (r & 4)) // 2 + 1
    if r & 3:
        need["words"] = T
    have = dict(tables)
    have["words"] = words
    for name, rows in need.items():
        t = have.get(name)
        if rows and (t is None or t.shape[0] < rows):
            raise ValueError(f"the walk of {nsteps} steps from anchor {anchor} needs {rows} "
                             f"rows of {name}, got {None if t is None else t.shape[0]}")


def _plane_walk(code: CodeSpec, words, tables: dict, num_data_bits: int, endstate,
                anchor: int, packed: bool):
    """Launch the table walk; returns ``(bits [B, n] or bytes [B, n // 8]
    uint8, state at anchor [B] int32)``, ``n`` the kept bits the plain
    version returns."""
    f4, f8, g2 = tables.get("f4"), tables.get("f8"), tables.get("g2")
    n = code.K - 1
    if anchor > n:
        raise ValueError("anchor must be <= K-1 (kept bits start at K-1)")
    if n < rp.MIN_N:
        raise ValueError(f"plane tables need K-1 >= {rp.MIN_N}, got {n}")
    maxw = 8 if f8 is not None else 4
    if words is None:
        table = f8 if f8 is not None else f4
        nwin, width, B, W = table.shape
        T = anchor + width * nwin
        dev = table.device
    else:
        T, B, W = words.shape
        dev = words.device
    if W != code.decision_words:
        raise ValueError(f"expected {code.decision_words} words a step, got {W}")
    _check_plan(tables, words, T, anchor, maxw)
    nkeep = max(0, min(num_data_bits, T - n))
    if packed and nkeep % 8:
        raise ValueError(f"bit count {nkeep} not a multiple of 8")
    ptrs = {}
    for name, t, planes in (("f8", f8, (8,)), ("f4", f4, (4,)), ("g2", g2, ())):
        if t is not None:
            _build.check_cuda_int32(name, t, (t.shape[0], *planes, B, W))
        ptrs[name] = None if t is None else t.data_ptr()
    wst = wsb = 0
    wptr = None
    if words is not None:
        if not words.is_cuda or words.dtype != torch.int32 or words.stride(2) != 1:
            raise ValueError("words: expected CUDA int32 [T, B, W] with unit word stride")
        wptr, wst, wsb = words.data_ptr(), words.stride(0), words.stride(1)
    end_ptr, end_kind, end_stride, end_value, _keep = _end_args(endstate, B, dev)
    out = torch.empty((B, nkeep // 8 if packed else nkeep), dtype=torch.uint8, device=dev)
    state = torch.empty((B,), dtype=torch.int32, device=dev)
    _build.launch("chainback_planes", "viterbi_plane_walk", dev, ptrs["f8"], ptrs["f4"],
                  ptrs["g2"], wptr, wst, wsb, end_ptr, end_kind, end_stride, end_value,
                  out.data_ptr(), state.data_ptr(), code.K, B, T, anchor, maxw, nkeep,
                  int(packed))
    return out, state


def chainback_plane_bits(code: CodeSpec, words: torch.Tensor | None, tables: dict,
                         num_data_bits: int, endstate: torch.Tensor | int = 0,
                         anchor: int = 0):
    """``radix_planes.chainback_plane_bits`` on the card: ``(bits [B, n]
    uint8, state at anchor [B] int32)``.  ``words``: time-major ``[T, B,
    W]`` int32 (any time and batch strides), or None for a table alone;
    ``tables``: ``f8`` and/or ``f4`` (contiguous), ``g2`` where the plan has
    a width-2 window.  ``endstate``: an int, or a 0-d, ``[B]`` or ``[1, B]``
    int32 or uint8 device tensor."""
    dev = (words if words is not None else tables.get("f8", tables.get("f4"))).device
    if dev.type != "cuda":
        return rp.chainback_plane_bits(code, words, tables, num_data_bits, endstate, anchor)
    return _plane_walk(code, words, tables, num_data_bits, endstate, anchor, False)


def chainback_planes_ref(code: CodeSpec, words: torch.Tensor | None, tables: dict,
                         num_data_bits: int, endstate: torch.Tensor | int = 0,
                         anchor: int = 0) -> torch.Tensor:
    """Plain version of ``chainback_planes``."""
    return rp.chainback_planes(code, words, tables, num_data_bits, endstate, anchor)


def chainback_planes(code: CodeSpec, words: torch.Tensor | None, tables: dict,
                     num_data_bits: int, endstate: torch.Tensor | int = 0,
                     anchor: int = 0) -> torch.Tensor:
    """Decoded bytes ``[B, num_data_bits // 8]`` (MSB-first) of the table
    walk, written by the kernel itself: no unpack or pack launch.  Arguments
    as ``chainback_plane_bits``."""
    dev = (words if words is not None else tables.get("f8", tables.get("f4"))).device
    if dev.type != "cuda":
        return chainback_planes_ref(code, words, tables, num_data_bits, endstate, anchor)
    return _plane_walk(code, words, tables, num_data_bits, endstate, anchor, True)[0]

