"""Benchmark runner: the port's analogue of the reference binary.

Port of ``ka9q_viterbi_comparison_tpu/harness/runner.py``.  The CLI mirrors
``./main -t SECS -n MIN_SAMPLES -o FILE`` (ref: src/main.cpp:300-330) and the
emitted JSON keeps the reference's per-test schema verbatim (ref: print_test,
src/main.cpp:80-118) so the reference's analysis scripts -- and this repo's
re-implementations in ``scripts/`` -- work on either implementation's output.

The test matrix is the reference's six configs at its frame sizes
(ref: src/main.cpp:363-419); "decoder families" become backends:

* ``cuda``  -- the hand-written CUDA kernels through ``dispatch.phase_fns``
  (every config; on ``--device cpu`` their plain versions).
* ``torch`` -- the portable tensor path (every config).
* ``native`` -- the host C++ decoder (``utils/native.py``), one frame at a
  time on the first ``NATIVE_BATCH`` frames, where ``g++`` is present: the
  reference's own CPU family, the comparison baseline.

Rows are named ``gpu_<backend>`` (``cpu_native`` for the host decoder) with
the numeric spec's tag (``_s16``, ``_ob``).  The run is on the card unless
``--device cpu`` is given, and raises without one.  Progress goes to stderr, samples to the JSON file -- the
reference's two output channels (ref: src/main.cpp:27-31).

    python -m ka9q_viterbi_comparison_tpu_torch.harness.runner -t 1 -n 8 -o out.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..configs import (
    BENCH_FRAME_BYTES,
    STANDARD_CODES,
    CodeSpec,
    ka9q_offset_binary_spec,
    soft8_spec,
    soft16_spec,
)
from ..models.decoder import resolve_device
from ..ops.encoder import encode_frames
from .bench import BACKENDS, run_phase_bench

__all__ = ["main", "run_matrix", "backends_for", "DEFAULT_BATCH", "NATIVE_BATCH", "KA9Q_CONFIGS"]

# Frames per iteration and config: the JAX package's benchmark batches, so
# that both packages name the same rows.  K <= 15 batches lie at or above the
# in-place route's threshold (128); K=24 keeps its decision storage small
# (about 1 MiB per frame and trellis step).
DEFAULT_BATCH = {
    "viterbi27": 512,
    "viterbi47": 512,
    "viterbi29": 512,
    "viterbi49": 256,
    "viterbi615": 256,
    "viterbi224": 8,
}

# Frames per iteration for the serial cpu_native family (kept small: it is
# the comparison baseline, not the throughput path); the JAX package's.
NATIVE_BATCH = {
    "viterbi27": 8, "viterbi47": 8, "viterbi29": 8, "viterbi49": 8,
    "viterbi615": 2, "viterbi224": 1,
}

# Configs the reference also runs under the ka9q family's offset-binary
# {0, 255} symbol convention (ref: src/viterbi_configs.h:15-20; the R=4 codes
# have no ka9q decoder, ref: src/main.cpp:374-398).
KA9Q_CONFIGS = {"viterbi27", "viterbi29", "viterbi615", "viterbi224"}


def backends_for(code: CodeSpec) -> list[str]:
    """Both device families serve every config; the host decoder joins them
    where ``g++`` is present."""
    from ..utils import native

    return ["cuda", "torch"] + (["native"] if native.available() else [])


def run_matrix(
    sampling_time: float,
    minimum_samples: int,
    out_fp,
    codes=STANDARD_CODES,
    batch_override: int | None = None,
    frame_bytes_override: int | None = None,
    seed: int = 0,
    backends: list[str] | None = None,
    device: torch.device | str = "cuda",
) -> None:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out_fp.write("[\n")
    first = True
    for code in codes:
        n_bytes = frame_bytes_override or BENCH_FRAME_BYTES[code.name]
        B = batch_override or DEFAULT_BATCH[code.name]
        # Numeric families per config: soft8 (the "ours" soft-decision rows),
        # soft16 (the reference's u16 columns exist for every config,
        # ref: src/viterbi_configs.h:22-35), plus the ka9q offset-binary
        # convention where the reference has a ka9q column.
        numerics = [(soft8_spec(code.R), ""), (soft16_spec(code.R), "_s16")]
        if code.name in KA9Q_CONFIGS:
            numerics.append((ka9q_offset_binary_spec(), "_ob"))
        for numeric, tag in numerics:
            print(f"[{code.name}] K={code.K} R={code.R} bytes={n_bytes} "
                  f"batch={B} numeric={numeric.name}",
                  file=sys.stderr, flush=True)
            data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
            symbols = encode_frames(code, numeric, torch.from_numpy(data)).to(device)
            for backend in (backends or backends_for(code)):
                print(f"- {backend}", file=sys.stderr, flush=True)
                if backend == "native":
                    nb = min(B, NATIVE_BATCH[code.name])
                    b_data, b_syms, name = data[:nb], symbols[:nb], f"cpu_native{tag}"
                else:
                    b_data, b_syms, name = data, symbols, f"gpu_{backend}{tag}"
                result = run_phase_bench(
                    code, numeric, b_data, b_syms,
                    name=name, backend=backend,
                    sampling_time=sampling_time, minimum_samples=minimum_samples,
                    device=device,
                )
                ber = result.total_bit_errors / float(result.total_bits)
                print(f"o {backend} ({ber:.3f})", file=sys.stderr, flush=True)
                if not first:
                    out_fp.write(",\n")
                first = False
                json.dump(result.to_json_obj(), out_fp)
    out_fp.write("\n]\n")
    out_fp.flush()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        "run_benchmark",
        description="Benchmark the PyTorch/CUDA Viterbi decoder families",
    )
    p.add_argument("-t", "--sampling-time", type=float, default=1.0,
                   metavar="SAMPLING_TIME", help="Amount of time to run decoder")
    p.add_argument("-n", "--minimum-samples", type=int, default=8,
                   metavar="MINIMUM_SAMPLES",
                   help="Minimum number of samples to accumulate")
    p.add_argument("-o", "--output", default="./data/benchmark_torch.json",
                   metavar="OUTPUT_FILENAME", help="Filename to output sample data")
    p.add_argument("--codes", nargs="*", default=None,
                   help="Subset of config names (default: all six)")
    p.add_argument("--batch", type=int, default=None, help="Override batch size")
    p.add_argument("--frame-bytes", type=int, default=None,
                   help="Override data bytes per frame")
    p.add_argument("--backends", nargs="*", default=None, choices=list(BACKENDS),
                   help="Subset of decoder families (default: all)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    codes = STANDARD_CODES
    if args.codes:
        by_name = {c.name: c for c in STANDARD_CODES}
        unknown = [n for n in args.codes if n not in by_name]
        if unknown:
            p.error(f"unknown config(s): {unknown}; choose from {sorted(by_name)}")
        codes = tuple(by_name[n] for n in args.codes)
    device = resolve_device(args.device)

    if args.output == "-":
        run_matrix(args.sampling_time, args.minimum_samples, sys.stdout, codes,
                   args.batch, args.frame_bytes, args.seed, args.backends, device)
    else:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            run_matrix(args.sampling_time, args.minimum_samples, f, codes,
                       args.batch, args.frame_bytes, args.seed, args.backends, device)


if __name__ == "__main__":
    main()
