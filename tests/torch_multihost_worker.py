"""One process of a multi-process decode of the port (gloo on the CPU).

    python tests/torch_multihost_worker.py RANK WORLD INIT_METHOD INPUT.npz OUT_DIR

Joins the process group at ``INIT_METHOD`` (``file://...``), decodes its
share of the inputs through ``parallel.multihost`` and writes its outputs to
``OUT_DIR/rank<RANK>.npz``: ``frames`` (frame DP, its rows of
``frame_symbols``), ``time_bits`` (its time block of ``time_symbols``) and,
where the input holds ``state_symbols``, ``state_bytes`` (the state axis
across the processes).  Imports nothing of JAX.
"""

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch.distributed as dist  # noqa: E402

from ka9q_viterbi_comparison_tpu_torch import STANDARD_CODES, soft8_spec  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.parallel import multihost  # noqa: E402


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_method, inp, out_dir = sys.argv[3], np.load(sys.argv[4]), pathlib.Path(sys.argv[5])
    codes = {c.name: c for c in STANDARD_CODES}
    multihost.initialize(init_method, world, rank, device="cpu")
    out = {}
    code = codes[str(inp["code"])]
    numeric = soft8_spec(code.R)
    nbits = int(inp["num_data_bits"])
    rows = np.array_split(inp["frame_symbols"], world)[rank]
    out["frames"] = multihost.decode_local_frames(code, numeric, rows, nbits)
    block = np.split(inp["time_symbols"], world, axis=1)[rank]
    out["time_bits"] = multihost.decode_local_time_blocks(code, numeric, block,
                                                          overlap=int(inp["overlap"]))
    if "state_symbols" in inp:
        scode = codes[str(inp["state_code"])]
        out["state_bytes"] = multihost.decode_state_sharded(
            scode, soft8_spec(scode.R), inp["state_symbols"], int(inp["state_bits"]))
    dist.destroy_process_group()
    np.savez(out_dir / f"rank{rank}.npz", **out)
    print(f"TORCH_MULTIHOST_OK rank={rank}")


if __name__ == "__main__":
    main()
