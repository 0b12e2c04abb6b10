#!/usr/bin/env python
"""Example: frame-parallel and time-block decoding on a mesh of shards.

Decodes 16 random 256-byte frames with the K=7 rate-1/2 code twice: with
the batch split over a ``frame`` axis of ``--shards`` shards (no
communication), and with each frame's stream split over a ``time`` axis of
as many blocks (halo exchange, truncated traceback).  All shards live on
one device: the card by default, ``--device cpu`` for the CPU.  Across
cards, ``parallel.multihost`` runs the same decode with one shard a process.

    python -m ka9q_viterbi_comparison_tpu_torch.examples.multichip_decode
"""

import argparse

import numpy as np
import torch.nn.functional as F

from ka9q_viterbi_comparison_tpu_torch import VITERBI27, soft8_spec
from ka9q_viterbi_comparison_tpu_torch.models.decoder import as_symbols, resolve_device
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.parallel import (Mesh, frame_sharded_decode,
                                                        time_block_decode)
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--shards", type=int, default=4, help="shards of each mesh (default 4)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    code, numeric = VITERBI27, soft8_spec(2)
    n_bytes, batch = 256, 16

    data = np.random.default_rng(0).integers(0, 256, size=(batch, n_bytes), dtype=np.uint8)
    syms = as_symbols(encode_frames(code, numeric, as_symbols(data, "cpu")), device)

    out = frame_sharded_decode(code, numeric, syms, n_bytes * 8,
                               Mesh({"frame": args.shards}, device))
    print(f"frame DP over {args.shards} shards on {device}: "
          f"{count_bit_errors(out, data)} bit errors")

    # Erasure symbols pad the stream to whole blocks: the last block walks
    # from state 0 at the true end.
    T = code.transmit_bits(n_bytes)
    mid = (numeric.soft_high + numeric.soft_low) // 2
    syms3 = F.pad(syms.reshape(batch, T, code.R), (0, 0, 0, (-T) % args.shards), value=mid)
    out = time_block_decode(code, numeric, syms3, n_bytes * 8, Mesh({"time": args.shards}, device))
    print(f"time blocks over {args.shards} shards on {device}: "
          f"{count_bit_errors(out, data)} bit errors")


if __name__ == "__main__":
    main()
