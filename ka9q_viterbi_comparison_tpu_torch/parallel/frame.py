"""Frame-level data parallelism.

Port of ``ka9q_viterbi_comparison_tpu/parallel/frame.py``.  Frames are
independent, so the batch is split over the ``frame`` mesh axis and every
shard decodes its rows with no communication: zero collectives.  Each
shard's rows go through ``models.functional.decode_symbols`` on the
kernels, so a shard takes the route an unsharded decode of its batch
would: the in-place pair at a shard batch of 128 or more (5 < K <= 15), the
state-order pair below (K <= 9), the large-K plan above K=15.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols
from ..models.functional import decode_symbols
from .mesh import Mesh

__all__ = ["frame_sharded_decode", "make_frame_mesh"]


def make_frame_mesh(n: int | None = None, axis: str = "frame",
                    device: torch.device | str = "cuda") -> Mesh:
    """1-D mesh of ``n`` shards for frame DP (default: one a process)."""
    if n is None:
        n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh({axis: n}, device)


def frame_sharded_decode(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    mesh: Mesh,
    frame_axis: str = "frame",
) -> torch.Tensor:
    """Decode ``[B, T*R]`` with B split over ``mesh[frame_axis]``: bytes
    ``[B, num_data_bits // 8]``.  With several processes, ``symbols`` and
    the result are this process's rows."""
    spec = (frame_axis,)
    shards = mesh.shard(as_symbols(symbols, mesh.device), spec)
    out = {}
    for j, c in enumerate(mesh.axis_coords(frame_axis)):
        if c not in out:  # shards replicated over other axes decode once
            out[c] = decode_symbols(code, numeric, shards[j], num_data_bits, backend="cuda",
                                    device=mesh.device)
    return mesh.unshard(torch.stack([out[c] for c in mesh.axis_coords(frame_axis)]), spec)
