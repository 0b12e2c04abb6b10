"""Multi-device parallelism: the port of ``ka9q_viterbi_comparison_tpu/parallel``.

Mesh axes (``mesh.py``: named axes over shards, the collectives of a
sharded decode, one process holding all shards on one device or each
process of a ``torch.distributed`` group holding its share):

* ``frame`` -- data parallelism over independent frames (``frame.py``).
* ``time``  -- sequence parallelism over time blocks of one long stream with
               traceback-overlap halo exchange (``timeblock.py``).
* ``state`` -- trellis state sharding for K=24's 8M-state metric vectors
               (``statewise.py``).

``state_time.py`` composes ``state`` x ``time`` for long large-K streams;
``multihost.py`` runs the same functions with one process a card.
"""

from .frame import frame_sharded_decode, make_frame_mesh
from .mesh import CollectiveCall, Mesh, backend_for, recording
from .state_time import pad_to_time_blocks, state_time_decode, state_time_decode_bits
from .statewise import state_sharded_decode, state_sharded_decode_bits
from .timeblock import default_overlap, time_block_decode, time_block_decode_bits

__all__ = [
    "frame_sharded_decode",
    "make_frame_mesh",
    "default_overlap",
    "pad_to_time_blocks",
    "state_sharded_decode",
    "state_sharded_decode_bits",
    "state_time_decode",
    "state_time_decode_bits",
    "time_block_decode",
    "time_block_decode_bits",
    "Mesh",
    "CollectiveCall",
    "backend_for",
    "recording",
]
