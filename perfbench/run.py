"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the inputs are made on the card from
``--seed``.  With ``--trace 0`` the line carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a profiler
trace of a stretch of the window.  The last lines on standard error, and the
``checks`` key that ends the line, give each number compared with the plain
reference beside its limit.  Exits non-zero, printing no result, without a
CUDA device (or with fewer than the cell asks for), or where a module of
JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import cell, spec  # noqa: E402


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name is one of ``cell.FORBIDDEN``."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in cell.FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    s = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < s.chips:
        print(f"perfbench: the cell needs {s.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = cell.run(s, args.seed, args.seconds, bool(args.trace), device, T_BEGIN)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
