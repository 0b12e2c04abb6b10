"""Multi-process decoding: one process a card, or several on the CPU.

Port of ``ka9q_viterbi_comparison_tpu/parallel/multihost.py``.  The JAX
module joins ``jax.distributed`` and assembles each process's frames into
one global array.  Here each process simply holds its own rows or its own
time block as the shards of a ``Mesh`` (``parallel/mesh.py``), so
"assembly" moves no data, and the collectives of the sharded decodes cross
the process boundary through ``torch.distributed``:

* ``initialize(...)`` -- ``torch.distributed.init_process_group`` with the
  backend of the device (NCCL for a card, one card a process; gloo for the
  CPU), from a ``file://``, ``env://`` or ``tcp://`` rendezvous.
* ``decode_local_frames(...)`` -- frame DP over all processes (no traffic).
* ``decode_state_sharded(...)`` -- the state axis spans processes: the
  butterfly's half-shard ``ppermute``s and the traceback's ``psum`` cross
  the boundary every trellis step.
* ``decode_local_time_blocks(...)`` -- the time axis spans processes: each
  holds a contiguous time block of the same frames, and the warm-up halos
  cross the boundary once.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols, resolve_device
from .frame import frame_sharded_decode
from .mesh import Mesh, backend_for
from .statewise import state_sharded_decode
from .timeblock import time_block_decode_bits

__all__ = [
    "initialize",
    "global_frame_mesh",
    "global_frame_batch",
    "decode_local_frames",
    "decode_local_time_blocks",
    "decode_state_sharded",
    "cross_process_time_mesh",
    "local_shard",
]


def initialize(init_method: str, num_processes: int, process_id: int,
               device: torch.device | str = "cuda") -> torch.device:
    """Join the process group (idempotent per process) and return this
    process's device: ``cuda:<process_id % cards>`` with NCCL, or the CPU
    with gloo.  No fallback from one backend to the other."""
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), init_method=init_method,
                                world_size=num_processes, rank=process_id)
        # A first collective over every rank: NCCL sets up its communicator
        # here, before any point-to-point batch that leaves a rank out.
        dist.barrier(device_ids=[device.index] if device.type == "cuda" else None)
    return device


def _device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if dist.is_initialized() else torch.device("cuda")


def global_frame_mesh(axis: str = "frame", device: torch.device | str | None = None) -> Mesh:
    """1-D mesh over all processes, one shard each, for frame DP."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh({axis: world}, device or _device())


def global_frame_batch(local, mesh: Mesh, axis: str = "frame") -> torch.Tensor:
    """This process's ``[B_local, ...]`` rows as its shards of the global
    batch (the concatenation in process order): ``[n_local, B_local /
    n_local, ...]`` on the mesh's device.  No data crosses processes."""
    return mesh.shard(as_symbols(local, mesh.device), (axis,))


def local_shard(shards: torch.Tensor) -> np.ndarray:
    """This process's rows of a frame-sharded ``[n_local, b, ...]`` tensor, in order."""
    return shards.reshape(-1, *shards.shape[2:]).cpu().numpy()


def decode_local_frames(
    code: CodeSpec,
    numeric: NumericSpec,
    local_symbols,
    num_data_bits: int,
    mesh: Mesh | None = None,
    axis: str = "frame",
) -> np.ndarray:
    """Decode this process's ``[B_local, T*R]`` frames as its part of the
    global frame-sharded batch: bytes ``[B_local, num_data_bits // 8]``."""
    mesh = mesh or global_frame_mesh(axis)
    out = frame_sharded_decode(code, numeric, as_symbols(local_symbols, mesh.device),
                               num_data_bits, mesh, axis)
    return out.cpu().numpy()


def decode_state_sharded(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    num_data_bits: int,
    mesh: Mesh | None = None,
    state_axis: str = "state",
) -> np.ndarray:
    """State-sharded decode with the state axis spanning processes.
    ``symbols [B, T, R]`` are replicated (every process passes the same);
    returns bytes ``[B, num_data_bits // 8]`` on every process."""
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = Mesh({state_axis: world}, _device())
    out = state_sharded_decode(code, numeric, symbols, num_data_bits, mesh, state_axis)
    return out.cpu().numpy()


def cross_process_time_mesh(frame_axis: str = "frame", time_axis: str = "time") -> Mesh:
    """2-D mesh with the time axis spanning processes: one time block, and
    all its frames, a process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh({time_axis: world, frame_axis: 1}, _device())


def decode_local_time_blocks(
    code: CodeSpec,
    numeric: NumericSpec,
    local_symbols,
    mesh: Mesh | None = None,
    overlap: int | None = None,
    frame_axis: str = "frame",
    time_axis: str = "time",
) -> np.ndarray:
    """Sequence-parallel decode with time blocks spanning processes.

    ``local_symbols``: this process's contiguous time block ``[B, Tb, R]``
    of the shared frames (blocks concatenate in process order to the global
    ``[B, T, R]`` stream).  Returns this process's trellis bits ``[B, Tb]``
    uint8.
    """
    mesh = mesh or cross_process_time_mesh(frame_axis, time_axis)
    bits = time_block_decode_bits(code, numeric, as_symbols(local_symbols, mesh.device), mesh,
                                  overlap, time_axis, frame_axis)
    return bits.cpu().numpy()
