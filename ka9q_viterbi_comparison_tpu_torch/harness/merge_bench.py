"""Merge the port's benchmark JSON files row-wise.

    python -m ka9q_viterbi_comparison_tpu_torch.harness.merge_bench out.json part1.json part2.json ...

The port's counterpart of ``tools/merge_bench.py``.  Later files override
earlier ones on the ``(name, K, R)`` key; rows that parse only partly (a
run cut mid-write) are dropped.  The output keeps the reference emitter's
one-object-per-line layout (ref: src/main.cpp:80-118) in matrix order:
config-major (K, then R ascending), then family order within a config.
"""

from __future__ import annotations

import json
import sys

__all__ = ["FAMILIES", "load_rows", "merge", "main"]

FAMILIES = ("gpu_cuda", "gpu_torch", "cpu_native",
            "gpu_cuda_s16", "gpu_torch_s16", "cpu_native_s16",
            "gpu_cuda_ob", "gpu_torch_ob", "cpu_native_ob")


def load_rows(path: str) -> list[dict]:
    """The rows of a benchmark JSON file; a file cut mid-write gives the
    rows that parse whole."""
    with open(path) as f:
        txt = f.read().strip()
    try:
        return json.loads(txt)
    except json.JSONDecodeError:
        rows = []
        for line in txt.splitlines():
            line = line.strip().rstrip(",")
            if not line.startswith("{"):
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"drop partial row in {path}: {line[:60]}...", file=sys.stderr)
        return rows


def merge(out_path: str, parts: list[str]) -> list[dict]:
    """Merge ``parts`` into ``out_path``; returns the rows written."""
    merged: dict = {}
    for p in parts:
        for row in load_rows(p):
            merged[(row["name"], row["K"], row["R"])] = row
    rows = sorted(merged.values(), key=lambda r: (r["K"], r["R"], FAMILIES.index(r["name"])))
    with open(out_path, "w") as f:
        f.write("[\n")
        f.write(",\n".join(json.dumps(r) for r in rows))
        f.write("\n]\n")
    return rows


def main(argv=None) -> None:
    out_path, *parts = sys.argv[1:] if argv is None else argv
    rows = merge(out_path, parts)
    print(f"{len(rows)} rows -> {out_path}")


if __name__ == "__main__":
    main()
