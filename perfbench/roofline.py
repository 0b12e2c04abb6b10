"""The least time the card could take for a kernel's work: the larger of its
bytes over the memory rate and its int32 operations over the int32 issue
rate (the arithmetic the port's ``PERF.md`` kernel table uses).

Peaks of one NVIDIA H100 SXM (80 GB HBM3), at the 700 W limit:

* memory: 3.35 TB/s, the data sheet's figure;
* int32: 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.727e12 adds, compares or
  selects a second, kept as 16.73e12 (the data sheet's 33.5 TOP/s counts a
  multiply-add as two).

Bytes count each input and each output once; operations count what the
trellis needs, not what a kernel issues.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "INT32_OPS_PER_S", "bound_s", "acs_bound_s", "walk_bound_s"]

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.73e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def acs_bound_s(K: int, R: int, B: int, T: int) -> float:
    """One ACS sweep of ``T`` steps over ``B`` frames: bytes = symbols in
    (int32), metrics in and out, decision words out (one bit a state);
    operations a frame and step = the 2^R penalty sums of R terms each, then
    6 a state (2 adds, compare, select, penalty index, packing)."""
    S = 1 << (K - 1)
    W = max(1, S // 32)
    nbytes = 4 * B * (T * R + 2 * S + T * W)
    ops = B * T * ((1 << R) * R + 6 * S)
    return bound_s(nbytes, ops)


def walk_bound_s(B: int, T: int, out_bytes: int, metric_bytes: int = 0) -> float:
    """One traceback over ``T`` steps of ``B`` frames: the one word a step and
    frame that the path needs, the end state, the output (``out_bytes``) and,
    where the walk starts from the argmin of the metrics, those once
    (``metric_bytes``); 8 operations a step (word select, bit extract, state
    update, bit pack)."""
    nbytes = 4 * B * (T + 1) + out_bytes + metric_bytes
    return bound_s(nbytes, B * T * 8)
