"""NumPy scalar oracle: an independent, deliberately simple Viterbi
implementation used only by tests as a cross-implementation oracle.

The port's own copy of ``ka9q_viterbi_comparison_tpu/ops/oracle.py`` (the port
imports nothing of the JAX package); it reads the port's ``configs``.

The reference validates correctness by running 3-6 independent decoder
implementations over the same stream and checking they all round-trip
(SURVEY §4; ref: src/main.cpp:110-115).  This module plays that role for the
port: it shares *no* code with the tensor and kernel paths beyond the static
config tables, and is written step-at-a-time so it is easy to audit against
the textbook algorithm.

Tie-breaking matches the framework contract (and ka9q's K=7/9 decoders,
ref: viterbi27_sse2.cpp:155-156): on equal candidates the low predecessor
(decision 0) wins.
"""

from __future__ import annotations

import numpy as np

from ..configs import CodeSpec, NumericSpec

__all__ = ["oracle_encode", "oracle_decode"]


def oracle_encode(code: CodeSpec, numeric: NumericSpec, data: np.ndarray) -> np.ndarray:
    """Encode one frame of uint8 ``[N]`` to soft symbols ``[T*R]`` int32 by
    literally clocking a shift register, MSB-first, with K-1 zero tail bits
    (semantics of ref: src/util.h:14-62)."""
    data = np.asarray(data, dtype=np.uint8)
    bits = np.unpackbits(data)  # MSB-first
    bits = np.concatenate([bits, np.zeros(code.K - 1, dtype=np.uint8)])
    ebits = code.expected_bits_table()  # [R, 2S]
    reg = 0
    out = np.empty(len(bits) * code.R, dtype=np.int32)
    mask = (1 << code.K) - 1
    for t, b in enumerate(bits):
        reg = ((reg << 1) | int(b)) & mask
        for r in range(code.R):
            bit = ebits[r, reg]
            out[t * code.R + r] = numeric.soft_high if bit else numeric.soft_low
    return out


def oracle_decode(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols: np.ndarray,
    num_data_bits: int,
    starting_state: int = 0,
    endstate: int = 0,
):
    """Decode one frame of soft symbols ``[T*R]`` to bytes
    ``[num_data_bits // 8]``.  Returns ``(data_bytes, path_metric)``."""
    S = code.num_states
    half = S // 2
    syms = np.asarray(symbols, dtype=np.int64).reshape(-1, code.R)
    T = syms.shape[0]
    ebits = code.expected_bits_table().astype(np.int64)  # [R, 2S]

    metrics = np.full(S, numeric.initial_margin, dtype=np.int64)
    metrics[starting_state & (S - 1)] = 0
    decisions = np.zeros((T, S), dtype=np.uint8)

    high = numeric.soft_high
    low = numeric.soft_low
    s2 = np.arange(half, dtype=np.int64)
    for t in range(T):
        new = np.empty(S, dtype=np.int64)
        for b in (0, 1):
            pen = np.zeros(half, dtype=np.int64)
            for h, old in ((0, metrics[:half]), (1, metrics[half:])):
                reg = ((s2 << 1) | b) | (h << (code.K - 1))
                p = np.zeros(half, dtype=np.int64)
                for r in range(code.R):
                    e = ebits[r, reg]
                    p += np.where(e == 1, high - syms[t, r], syms[t, r] - low)
                if h == 0:
                    cand_lo = old + p
                else:
                    cand_hi = old + p
            dec = cand_hi < cand_lo
            new[b::2] = np.where(dec, cand_hi, cand_lo)
            decisions[t, b::2] = dec.astype(np.uint8)
        metrics = new

    # Traceback.
    state = endstate & (S - 1)
    path_metric = int(metrics[state])
    bits = np.zeros(T, dtype=np.uint8)
    for t in range(T - 1, -1, -1):
        k = int(decisions[t, state])
        bits[t] = k
        state = (state >> 1) | (k << (code.K - 2))
    # Decision at transition t selects the predecessor's top bit = data bit
    # b_{t-K+1}; drop the first K-1 outputs (bits of the initial state).
    data_bits = bits[code.K - 1 : code.K - 1 + num_data_bits]
    return np.packbits(data_bits), path_metric
