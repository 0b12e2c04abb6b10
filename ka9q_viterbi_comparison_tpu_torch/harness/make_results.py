"""Generate ``RESULTS_TORCH.md`` from the port's benchmark JSON.

    python -m ka9q_viterbi_comparison_tpu_torch.harness.make_results data/benchmark_torch.json \\
        --chip-name "NVIDIA H100 80GB HBM3, 700.00 W"

The port's counterpart of ``tools/make_results.py``.  ``RESULTS_TORCH.md`` is
a generated file: the tables are the tabulation of the JSON (mean ± std of
per-sample rates, as ``scripts/tabulate_data.py`` prints them), and the
section against the reference -- per-cell ratios to its best-machine columns
and the list of losing cells -- comes from ``check_results`` on the same
rows.  ``render`` raises unless the matrix passes ``check_results``, and
``tests/test_torch_results_quality.py`` pins the checked-in file to
``render`` of the checked-in JSON, so no claim in it is written by hand.
Plots are not made (``--no-plots`` is the only mode).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import bench, check_results

__all__ = ["fmt", "si_scale", "tables", "render", "main", "TITLE"]

TITLE = "# Results — "
_SI = [(1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k"), (1.0, "")]


def _unique(it):
    """Order-preserving unique."""
    seen = set()
    for x in it:
        if x not in seen:
            seen.add(x)
            yield x


def si_scale(value: float) -> tuple[str, float]:
    """``(prefix, scale)`` such that ``value / scale`` is in [1, 1000)."""
    v = abs(value)
    for scale, prefix in _SI:
        if v >= scale:
            return prefix, scale
    return "", 1.0


def fmt(values: np.ndarray) -> str:
    """Mean ± std of per-sample rates, three significant digits."""
    avg, std = float(np.mean(values)), float(np.std(values))
    prefix, scale = si_scale(avg)
    return f"{avg / scale:.3g}±{std / scale:.2g}{prefix}"


def _rates(r: dict, phase: str) -> np.ndarray:
    """Per-sample rates of a row (the reference's metric definitions,
    ref: scripts/tabulate_data.py:33, :54): update symbols/s, chainback
    bits/s."""
    ns = np.asarray(r[f"{phase}_ns"], dtype=np.float64)
    total = r["total_output_symbols"] if phase == "update" else r["total_input_bytes"] * 8
    return total / (ns * 1e-9)


def _table(title: str, rows: list[dict], phase: str) -> str:
    names = list(_unique(r["name"] for r in rows))
    kr_list = list(_unique((r["K"], r["R"]) for r in rows))
    lines = [f"## {title}",
             "| K | R | {0} |".format(" | ".join(names)),
             "| {0} |".format(" | ".join(["---"] * (len(names) + 2)))]
    for K, R in kr_list:
        by_name = {r["name"]: r for r in rows if (r["K"], r["R"]) == (K, R)}
        cells = [fmt(_rates(by_name[n], phase)) if n in by_name else "---" for n in names]
        lines.append(f"| {K} | {R} | {' | '.join(cells)} |")
    return "\n".join(lines) + "\n"


def tables(filename: str) -> str:
    """The two rate tables of a benchmark JSON, as ``scripts/tabulate_data.py``
    prints them."""
    with open(filename) as f:
        rows = json.load(f)
    return (_table("Update symbol rate", rows, "update") + "\n"
            + _table("Chainback bit rate", rows, "chainback"))


def _ratio_cell(entry: dict, phase: str) -> str:
    if phase not in entry:
        return "---"
    e = entry[phase]
    return f"{e['ratio']:.2f}x {e['column']}"


def render(filename: str, chip_name: str) -> str:
    """The full ``RESULTS_TORCH.md`` text for a claim-grade benchmark JSON."""
    problems = check_results.check(filename)
    if problems:
        raise SystemExit("not claim-grade:\n" + "\n".join(f"FAIL {x}" for x in problems))
    with open(filename) as f:
        rows = json.load(f)
    vs = check_results.vs_baseline_rows(rows)
    losing = check_results.losing_cells(rows)
    windows = sorted({(r["sampling_time"], r["minimum_samples"]) for r in rows})
    window_text = "; ".join(f"at least {t:g} s and {n} samples a row (`-t {t:g} -n {n}`)"
                            for t, n in windows)

    header = f"""{TITLE}{chip_name}

Benchmark of the PyTorch/CUDA port's decoder families over the reference's
six-config matrix, at the reference's frame sizes, by
`ka9q_viterbi_comparison_tpu_torch/harness/runner.py`:
{window_text}.
The title names the card and its power limit as `nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader` prints them.  Metric
definitions are the reference's analysis scripts': update symbol rate =
total_output_symbols / update_ns; chainback bit rate = total_input_bytes*8 /
chainback_ns (mean±std over the raw per-iteration samples).  One iteration
decodes the whole batch of frames of its row.

How a sample is timed.  On the card a phase sample is the time between two
CUDA events recorded on the stream around a chain of k executions of the
phase, divided by k.  The update chain feeds each link's metrics to the
next; the traceback chain starts each link from the end state of the one
before; no link waits for the host.  k is chosen once a row, from one probed
execution, at most {bench.MAX_LINKS} links.  A `gpu_cuda` chain is captured
once a row as a CUDA graph and each sample replays it (about
{bench.CHAIN_TARGET_NS / 1e6:g} ms of chain): the kernels' time, with no
Python between links, as the JAX harness's chains run as one jitted program.
A `gpu_torch` chain is issued from Python as the portable path runs, and
lasts about {bench.HOST_CHAIN_NS / 1e9:g} s.  `cpu_native` phases are timed on
the host's monotonic clock, one link a chain.  So a `gpu_cuda` cell is the
time of a graph-replayed chain of `phase_fns` phases, not of a call through
`ViterbiDecoder`: a decoder call adds the host's issue time and, in the
traceback, the launches that unpack the walk's bit words and pack the bytes
(`dispatch.walk_bytes`), and through the decoder the ICE traceback phase
loses to its column (`PERF.md` §5).  Families:

* `gpu_cuda`   — the hand-written CUDA kernels for the H100 through
  `ops/cuda/dispatch.py` `phase_fns`, in the kernels' own layouts (K ≤ 9:
  the in-place rotating-address warp kernels at the runner's batches;
  Cassini: the in-place block kernel; K=24: the depth-4 octet kernel that
  writes the f8 walk table, walked 8 steps a fetch by the table-walk
  kernel).  The claim route: the gate requires it to beat every column.
* `gpu_torch`  — the portable PyTorch path on the card (`ops/acs.py`,
  `ops/chainback.py`): every trellis or walk step is a round of PyTorch
  launches from the host.
* `cpu_native` — the C++ host decoder (`utils/native.py`), one frame at a
  time on the first frames of the batch: the in-repo CPU column, to be read
  against the reference's desktop-CPU numbers only directionally.
* `*_ob`       — the same backends under the ka9q offset-binary (0, 255)
  symbol convention (ref: src/viterbi_configs.h:15-20), for the configs the
  reference also runs through its ka9q family.
* `*_s16`      — the soft16 {{-127,+127}} numeric family (ref: the u16
  columns of the reference's tables, src/viterbi_configs.h:22-35).

Init phase: the runner emits each iteration's metric reset as `init_ns` for
the schema; it is a metric fill, not a phase of the reference's tables, and
the tables here leave it out.

Reference hardware numbers are in `BASELINE.md`; the per-cell comparison is
the generated section at the bottom of this file.  This matrix passed
`ka9q_viterbi_comparison_tpu_torch/harness/check_results.py`:
no sample at or below the {check_results.FLOOR_NS} ns floor, claim-row stds at most
{check_results.MAX_REL_STD:.0%}, no traceback beyond the card's HBM roofline
by the bytes a decoded bit of the walk its row runs (`walk_bytes_per_bit`,
the words the walk fetches: on the CUDA route
{check_results.walk_bytes_per_bit("gpu_cuda", 15):g} B at K = 10-15 and {check_results.walk_bytes_per_bit("gpu_cuda", 24):g} B above K=15;
all W words a step elsewhere), BER 0, K=9 chainback at most
{check_results.K9_OVER_K7}x K=7's, and every `gpu_cuda*` cell above its
reference column.  `tests/test_torch_results_quality.py` re-runs the gate on
every suite run and pins this file to `harness/make_results.py` `render()` of
the checked-in JSON.

"""

    vs_section = """
## vs reference (AMD 7735HS, the baseline's best machine)

Every `gpu_*` cell against its comparison column in BASELINE.md:19-39 (mean
per-sample rate over the same samples as the tables above).  Comparison
columns: plain rows vs the reference's BEST column for that (K, R); `_ob`
rows vs the ka9q column (the offset-binary family match); `_s16` rows vs the
best u16 column.  Ratios above 1.00x beat the reference; `check_results`
fails any matrix where a `gpu_cuda*` cell drops below 1.00x.

| K | R | family | update vs ref | chainback vs ref |
| --- | --- | --- | --- | --- |
"""
    for e in vs:
        vs_section += (f"| {e['K']} | {e['R']} | {e['name']} | "
                       f"{_ratio_cell(e, 'update')} | {_ratio_cell(e, 'chainback')} |\n")

    if losing:
        vs_section += ("\nCells that do NOT beat their comparison column (generated from the "
                       "data; the gate\nallows them only on the portable `gpu_torch` route):\n\n")
        for c in losing:
            vs_section += f"- {c}\n"
    else:
        vs_section += ("\nEvery `gpu_*` cell beats its comparison column (generated from the "
                       "data).\n")

    return header + tables(filename) + vs_section


def main(argv=None) -> None:
    p = argparse.ArgumentParser("make_results")
    p.add_argument("filename", nargs="?", default="data/benchmark_torch.json")
    p.add_argument("--chip-name", required=True,
                   help="the card and its power limit, as nvidia-smi "
                        "--query-gpu=name,power.limit --format=csv,noheader prints them")
    p.add_argument("--out", default="RESULTS_TORCH.md")
    p.add_argument("--no-plots", action="store_true",
                   help="the only mode: no plots are made")
    args = p.parse_args(argv)
    with open(args.out, "w") as f:
        f.write(render(args.filename, args.chip_name))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
