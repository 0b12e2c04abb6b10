"""The benchmark's control: the plain reference put in the port's place with
a tie sent to the high predecessor (SPIRAL's ``min`` select) instead of the
low one the configuration states (each entry kind's ``Control``).  Every
compared number counts what differs from the reference proper, so a sound
comparison must find the control not correct.  Not run by the benchmark's own runs.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3

Runs the cell's set-up and a short window (enough calls to cover the pool
twice, and for a stream the pushes past the two periods that the reference
extrapolates) on each seed in one process, and prints one JSON line a seed
with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from perfbench import cell, entries, spec  # noqa: E402


def run_control(s: spec.Spec, seed: int, device: torch.device) -> dict:
    """One run of the cell with its entry's ``Control`` in the port's place."""
    control = entries.load(s.traffic["entry"]).Control
    return cell.run(s, seed, 1e9, False, device, time.perf_counter(), program=control,
                    max_calls=control.CALLS_PER_POOL * int(s.traffic["pool"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    s = spec.load(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        res = run_control(s, seed, device)
        print(json.dumps({"workload": s.name, "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
