"""Headline benchmark of the PyTorch/CUDA port: K=7 rate-1/2 symbol-update
throughput on one GPU.

    python3 bench_torch.py [--batch 512] [--bytes 1024] [--device cuda]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Mirrors the reference's hot metric -- symbol-update rate for the viterbi27
config over 1024-byte frames (ref: src/main.cpp:363-372; rate definition
scripts/tabulate_data.py:33) -- as ``bench.py`` does for the JAX package:
soft8 symbols, B frames a decode, the update phase of ``dispatch.phase_fns``
(symbols staged on the device beforehand), timed by
``harness.bench.time_update_marginal`` with CUDA events around a chain of
updates.  ``vs_baseline`` divides by 553 Msym/s, the reference's best
single-core CPU SIMD figure (BASELINE.md, AMD 7735HS sse-u8): a CPU number,
named as such, not a GPU target.

Runs on the card and raises without one; ``--device cpu`` runs the kernels'
plain versions at whatever size is asked (a check of the plumbing, not a
measurement).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ka9q_viterbi_comparison_tpu_torch import VITERBI27, soft8_spec  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.harness.bench import time_update_marginal  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.models.decoder import resolve_device  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames  # noqa: E402

BASELINE_SYM_PER_S = 553e6  # BASELINE.md: best reference update rate, K=7 R=2, one CPU core


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=512, help="frames per decode")
    p.add_argument("--bytes", type=int, default=1024, help="data bytes per frame")
    p.add_argument("--iters", type=int, default=7)
    p.add_argument("--chain", type=int, default=16, help="updates per timed chain")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)  # raises without a card unless cpu is asked
    code, numeric = VITERBI27, soft8_spec(2)
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, size=(args.batch, args.bytes), dtype=np.uint8)
    symbols = encode_frames(code, numeric, torch.from_numpy(data)).reshape(args.batch, -1, code.R)
    sym_per_s = time_update_marginal(code, numeric, symbols, backend=args.backend,
                                     n_chain=args.chain, iters=args.iters, device=device)
    print(json.dumps({
        "metric": "viterbi27_update_throughput",
        "value": round(sym_per_s / 1e6, 3),
        "unit": "Msym/s",
        "vs_baseline": round(sym_per_s / BASELINE_SYM_PER_S, 4),
    }))


if __name__ == "__main__":
    main()
