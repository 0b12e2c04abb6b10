"""Claim-grade gate for the port's benchmark JSON.

    python -m ka9q_viterbi_comparison_tpu_torch.harness.check_results data/benchmark_torch.json

The port's counterpart of the JAX package's repo-root gate
(``tools/check_results.py``), over ``harness/runner.py``'s rows.  A matrix
is claim-grade when:

1. no update or chainback sample sits at or below ``FLOOR_NS`` (1 us), and
   no sample of any phase is at or below zero.  On the card each sample is
   a chain's CUDA-event time over its links (``harness/bench.py``); a phase
   that launches at least one kernel cannot honestly take under 1 us a
   link, so such a sample means a misfired chain, not a fast phase.  The
   harness has no floor retries (CUDA events need none), so a floored
   sample is refused outright.  Init samples (a metric fill) may sit under
   the floor, as in the JAX gate, but not at or below zero;
2. every claim row -- update and chainback of the ``gpu_*`` families, the
   ones compared with the reference -- has std/mean <= 15 %
   (``cpu_native`` is the directional host column: BER- and floor-gated
   only);
3. no chainback rate implies traffic beyond the card's HBM roofline
   (``utils/chipinfo.py``), counting the bytes a decoded bit of the walk the
   row's family runs (``walk_bytes_per_bit``): the JAX gate's byte model for
   ``gpu_torch*`` and ``cpu_native*`` rows (all W = 2^(K-1)/32 words x 4 B a
   step at K <= 15, a word a ``W_WALK`` steps above), the words the CUDA
   walk fetches for ``gpu_cuda*`` rows (the same at K <= 9, 24.8 B a bit at
   K = 10-15, 0.5 B above K=15);
4. the bit error rate is exactly 0 on every (noiseless) row;
5. chainback does not speed up as the trellis grows within a backend (K=9
   at most 1.2x K=7: four times the words a step cannot be faster);
6. every ``gpu_cuda*`` cell beats its comparison column in the reference's
   best-machine tables (``BASELINE.md:19-39``, copied below): soft8 rows
   against the best column, ``_ob`` rows against the ka9q column (the
   offset-binary family), ``_s16`` rows against the best u16 column.
   ``gpu_torch*`` cells may lose, but ``losing_cells`` enumerates them, and
   ``harness/make_results.py`` writes that list into ``RESULTS_TORCH.md``.

Every threshold is the JAX gate's.  Exit 0 = claim-grade; otherwise every
violation is printed.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from ..ops.radix_planes import W_WALK
from ..utils.chipinfo import chip_info

__all__ = ["comparison_for", "mean_rate", "vs_baseline_rows", "losing_cells", "check",
           "check_rows", "walk_bytes_per_bit", "main", "FLOOR_NS", "MAX_REL_STD", "CLAIM_FAMILY",
           "BASELINE_UPDATE", "BASELINE_CHAINBACK"]

FLOOR_NS = 1_000
MAX_REL_STD = 0.15
K9_OVER_K7 = 1.2
HBM_BYTES_PER_S = chip_info().hbm_bytes_per_s
CLAIM_FAMILY = "gpu_cuda"  # rule 6: these cells may not lose

# Rule 3's walks on the card (``tests/test_torch_check_results.py`` holds
# these to ``csrc/viterbi_small.cu`` and ``csrc/viterbi_walk.cu``).
WORD_BYTES = 4           # a decision word: 32 states' bits
CB_STAGED_MAX_WORDS = 8  # launch_chainback stages W <= 8 words a step (K <= 9)
CB_DEPTH = 5             # kCbDepth: steps a round of chainback_kernel<ROT, 0>
CB_ROUND_FETCHES = (1 << CB_DEPTH) - 1  # lanes that fetch a candidate's word a round
PLANE_WINDOW = 8         # steps a fetch of plane_walk_kernel's f8 table

# ---------------------------------------------------------------------------
# Reference baseline: AMD 7735HS / clang 16, the reference's best machine
# (BASELINE.md:19-39).  Units: update sym/s, chainback bit/s; keys (K, R);
# "---" cells (no ka9q decoder for R=1/4 codes, no SPIRAL K=24) are absent.
COLUMNS = ("ka9q", "spiral", "sse_u8", "avx_u8", "sse_u16", "avx_u16")

BASELINE_UPDATE = {
    (7, 2):  {"ka9q": 465e6, "spiral": 457e6, "sse_u8": 553e6,
              "avx_u8": 485e6, "sse_u16": 321e6, "avx_u16": 406e6},
    (7, 4):  {"spiral": 589e6, "sse_u8": 922e6, "avx_u8": 952e6,
              "sse_u16": 476e6, "avx_u16": 774e6},
    (9, 2):  {"ka9q": 152e6, "spiral": 137e6, "sse_u8": 167e6,
              "avx_u8": 248e6, "sse_u16": 79.1e6, "avx_u16": 136e6},
    (9, 4):  {"spiral": 198e6, "sse_u8": 242e6, "avx_u8": 361e6,
              "sse_u16": 120e6, "avx_u16": 210e6},
    (15, 6): {"ka9q": 3.19e6, "spiral": 3.5e6, "sse_u8": 3.31e6,
              "avx_u8": 5.7e6, "sse_u16": 2.13e6, "avx_u16": 3.81e6},
    (24, 2): {"ka9q": 1.09e3, "sse_u8": 2.57e3, "avx_u8": 2.82e3,
              "sse_u16": 1.09e3, "avx_u16": 1.13e3},
}

BASELINE_CHAINBACK = {
    (7, 2):  {"ka9q": 509e6, "spiral": 475e6, "sse_u8": 867e6,
              "avx_u8": 876e6, "sse_u16": 875e6, "avx_u16": 872e6},
    (7, 4):  {"spiral": 474e6, "sse_u8": 871e6, "avx_u8": 861e6,
              "sse_u16": 877e6, "avx_u16": 876e6},
    (9, 2):  {"ka9q": 448e6, "spiral": 469e6, "sse_u8": 388e6,
              "avx_u8": 396e6, "sse_u16": 389e6, "avx_u16": 389e6},
    (9, 4):  {"spiral": 471e6, "sse_u8": 391e6, "avx_u8": 395e6,
              "sse_u16": 393e6, "avx_u16": 396e6},
    (15, 6): {"ka9q": 91.5e6, "spiral": 93e6, "sse_u8": 88.2e6,
              "avx_u8": 90.9e6, "sse_u16": 86.4e6, "avx_u16": 87.5e6},
    (24, 2): {"ka9q": 3.41e6, "sse_u8": 3.68e6, "avx_u8": 3.51e6,
              "sse_u16": 3.58e6, "avx_u16": 3.62e6},
}


def comparison_for(name: str, K: int, R: int, phase: str):
    """The reference cell a row is claimed against: ``(value, label)``, or
    None where the reference has no number for this (family, K, R) or the
    row is not a claim row (``cpu_native`` is the directional host
    column)."""
    table = BASELINE_UPDATE if phase == "update" else BASELINE_CHAINBACK
    cols = table.get((K, R))
    if cols is None or not name.startswith("gpu_"):
        return None
    if name.endswith("_ob"):
        if "ka9q" not in cols:
            return None
        return cols["ka9q"], "ka9q"
    if name.endswith("_s16"):
        sub = {c: v for c, v in cols.items() if c.endswith("_u16")}
    else:  # soft8 rows claim against the best column outright
        sub = cols
    label, value = max(sub.items(), key=lambda kv: kv[1])
    return value, label


def mean_rate(r: dict, phase: str) -> float:
    """Mean per-sample rate, the tabulator's estimator (``make_results.fmt``
    over per-sample rates)."""
    ns = r[f"{phase}_ns"]
    total = (r["total_output_symbols"] if phase == "update"
             else r["total_input_bytes"] * 8)
    return sum(total / (x * 1e-9) for x in ns) / len(ns)


def vs_baseline_rows(rows: list[dict]) -> list[dict]:
    """Per ``gpu_*`` row: measured rates, comparison cells, ratios.  A phase
    with a sample at or below zero has no rate (rule 1 refuses it), so it
    gets no comparison (the JAX gate divides by zero there)."""
    out = []
    for r in rows:
        if not r["name"].startswith("gpu_"):
            continue
        entry = {"name": r["name"], "K": r["K"], "R": r["R"]}
        for phase in ("update", "chainback"):
            cmp = comparison_for(r["name"], r["K"], r["R"], phase)
            if cmp is None or min(r[f"{phase}_ns"]) <= 0:
                continue
            base, label = cmp
            rate = mean_rate(r, phase)
            entry[phase] = {"rate": rate, "baseline": base,
                            "column": label, "ratio": rate / base}
        out.append(entry)
    return out


def losing_cells(rows: list[dict]) -> list[str]:
    """Every ``gpu_*`` cell that does NOT beat its comparison column.
    ``make_results`` writes this list into ``RESULTS_TORCH.md``; ``check``
    turns any ``gpu_cuda*`` member into a failure."""
    out = []
    for e in vs_baseline_rows(rows):
        for phase in ("update", "chainback"):
            if phase in e and e[phase]["ratio"] < 1.0:
                out.append(
                    f"{e['name']} K={e['K']} R={e['R']} {phase} "
                    f"({e[phase]['ratio']:.2f}x the reference {e[phase]['column']} column)")
    return out


def walk_bytes_per_bit(name: str, K: int) -> float:
    """Bytes a decoded bit that rule 3 counts for a row: 4 B times the
    fewest words the row's walk fetches a decoded bit.

    ``gpu_cuda*``: where ``launch_chainback`` stages a step's W <= 8 words
    (K <= 9) it copies all of them, the JAX count.  At K = 10-15
    ``chainback_kernel<ROT, 0>`` fetches, in each round of ``CB_DEPTH``
    steps, the word of each of the 2^d candidate positions d = 0..4 steps
    back: ``CB_ROUND_FETCHES`` = 31 words a round, 31 x 4 / 5 = 24.8 B a
    bit.  Over a frame of T steps that is 31 floor(T/5) + 2^(T mod 5) - 1
    fetches, and since T >= 8 bytes + 4 it is never below the closed form.
    The eight frames of a block share a 32-B sector of each [t, w] row, so
    a fetch moves at least its own 4 B; a sector a fetch (198.4 B a bit) is
    what random data usually costs, but not a bound.  The count is of the
    lanes' loads: the canonical words' candidates lie in 31 distinct words
    at K >= 10, and the rotated form's (the in-place words) share a word
    where their bits lie below bit 5 (``PERF.md`` §7).  Above K=15 the f8
    table walk of ``phase_fns`` fetches one word a ``PLANE_WINDOW`` = 8-step
    window: 0.5 B a bit (its f4 route fetches twice as often).

    Every other family keeps the JAX gate's count: all W words a step at
    K <= 15, one word a ``W_WALK`` steps above."""
    W = max(1, (1 << (K - 1)) // 32)
    if name.startswith(CLAIM_FAMILY) and W > CB_STAGED_MAX_WORDS:
        if K <= 15:
            return CB_ROUND_FETCHES * WORD_BYTES / CB_DEPTH
        return WORD_BYTES / PLANE_WINDOW
    return W * WORD_BYTES if K <= 15 else WORD_BYTES / W_WALK


def check_rows(rows: list[dict], hard_only: bool = False) -> list[str]:
    """Every violation in ``rows``.  ``hard_only`` leaves out rule 2 (the
    std rule), for windows too short to gate it."""
    problems: list[str] = []
    cb_rate: dict[tuple[str, int], float] = {}
    for r in rows:
        name, K = r["name"], r["K"]
        tag = f"{name} K={K} R={r['R']}"
        nonpos = sum(1 for x in r["init_ns"] if x <= 0)
        if nonpos:
            problems.append(f"{tag}: {nonpos}/{len(r['init_ns'])} init samples at or below 0 ns")
        for phase in ("update", "chainback"):
            ns = r[f"{phase}_ns"]
            floored = sum(1 for x in ns if x <= FLOOR_NS)
            if floored:
                problems.append(f"{tag}: {floored}/{len(ns)} {phase} samples "
                                f"on the {FLOOR_NS} ns floor")
            if hard_only or not name.startswith("gpu_"):
                continue  # claim rows only (see module docstring)
            mu = sum(ns) / len(ns)
            sd = math.sqrt(sum((x - mu) ** 2 for x in ns) / len(ns))
            if mu > 0 and sd / mu > MAX_REL_STD:
                problems.append(f"{tag}: {phase} std {sd/mu:.0%} > "
                                f"{MAX_REL_STD:.0%} of mean")
        if r["bit_error_rate"] != 0:
            problems.append(f"{tag}: nonzero BER {r['bit_error_rate']}")

        cb_ns = sum(r["chainback_ns"]) / len(r["chainback_ns"])
        if cb_ns <= 0:
            continue  # refused above; no rate to check
        rate = r["total_input_bytes"] * 8 / (cb_ns * 1e-9)  # aggregate bit/s
        bytes_per_bit = walk_bytes_per_bit(name, K)
        if rate * bytes_per_bit > HBM_BYTES_PER_S:
            problems.append(
                f"{tag}: chainback {rate/1e9:.3g} Gbit/s x {bytes_per_bit} "
                f"B/bit exceeds the {HBM_BYTES_PER_S/1e9:.0f} GB/s HBM roofline")
        if K in (7, 9) and r["R"] == 2:
            cb_rate[(name, K)] = rate

    for backend in sorted({b for b, _ in cb_rate}):
        k7, k9 = cb_rate.get((backend, 7)), cb_rate.get((backend, 9))
        if k7 and k9 and k9 > K9_OVER_K7 * k7:
            problems.append(
                f"{backend}: K=9 chainback ({k9/1e9:.3g} G) implausibly beats "
                f"K=7 ({k7/1e9:.3g} G) by >{K9_OVER_K7}x (4x the words/step)")

    # Rule 6: the performance claim is the CUDA route -- every gpu_cuda cell
    # must beat its reference comparison column.
    for cell in losing_cells(rows):
        if cell.startswith(CLAIM_FAMILY):
            problems.append(f"claim violation: {cell} -- a cuda cell "
                            f"may not lose to its baseline column")
    return problems


def check(path: str) -> list[str]:
    """Every violation in the benchmark JSON at ``path``."""
    with open(path) as f:
        rows = json.load(f)
    return check_rows(rows)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("check_results")
    p.add_argument("filename", nargs="?", default="data/benchmark_torch.json")
    args = p.parse_args(argv)
    problems = check(args.filename)
    if problems:
        for x in problems:
            print(f"FAIL {x}")
        sys.exit(1)
    print(f"OK {args.filename}: claim-grade (no floored samples, stds <= "
          f"{MAX_REL_STD:.0%}, rooflines respected, BER 0, every {CLAIM_FAMILY} cell beats "
          f"its reference column)")


if __name__ == "__main__":
    main()
