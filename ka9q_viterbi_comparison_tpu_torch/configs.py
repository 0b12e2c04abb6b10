"""Code + numeric configuration of the PyTorch/CUDA port.

A copy of ``ka9q_viterbi_comparison_tpu/configs.py`` (numpy only), kept here so
the port imports nothing of the JAX package.  Field names, values and the
trellis conventions are identical; ``convert.code_from_fields`` carries a
JAX-side spec across.

* ``CodeSpec``      <-> the (K, R, poly) template arguments and hardcoded test
                        matrix of the reference harness
                        (ref: src/main.cpp:363-419).
* ``NumericSpec``   <-> the reference's ``Decoder_Config`` numeric policies
                        (ref: src/viterbi_configs.h:15-65): soft-decision rail
                        values, initial metric biases and renormalisation
                        policy.

Trellis conventions used throughout the framework (all derived from the
behaviour of the reference decoders, ref: ka9q_libfec_port/viterbi27_sse2.cpp):

* ``S = 2**(K-1)`` states; the state is the low K-1 bits of the encoder shift
  register.
* Transition: ``state' = ((state << 1) | bit) & (S - 1)`` -- the new data bit
  enters at the LSB.
* Expected symbol ``r`` for the transition taken from state ``s`` with input
  bit ``b`` is ``parity(((s << 1) | b) & poly[r])``, optionally inverted when
  the polynomial is marked inverted (negative, as in the SPIRAL decoders,
  ref: spiral/spiral27.cpp:69).
* Input bytes are consumed MSB-first and decoded bytes are produced MSB-first
  (the bit order the reference's chainback byte-accumulation trick produces,
  ref: ka9q_libfec_port/viterbi27_sse2.cpp:97-103).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "CodeSpec",
    "NumericSpec",
    "VITERBI27",
    "VITERBI47",
    "VITERBI29",
    "VITERBI49",
    "VITERBI615",
    "VITERBI224",
    "STANDARD_CODES",
    "BENCH_FRAME_BYTES",
    "ka9q_offset_binary_spec",
    "soft16_spec",
    "soft8_spec",
    "hard8_spec",
]


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A convolutional code: constraint length, rate 1/R and polynomials.

    ``polys`` uses the ka9q bit convention: bit ``j`` of a polynomial taps
    shift-register bit ``j`` where bit 0 is the newest (current input) bit.
    A negative polynomial means the output bit is inverted (SPIRAL extension).
    """

    name: str
    K: int
    R: int
    polys: tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.polys) != self.R:
            raise ValueError(f"{self.name}: expected {self.R} polynomials, got {len(self.polys)}")
        if not (2 <= self.K <= 24):
            raise ValueError(f"{self.name}: K={self.K} out of supported range [2, 24]")
        for p in self.polys:
            if abs(p) >= (1 << self.K):
                raise ValueError(f"{self.name}: polynomial {p:o} wider than K={self.K} bits")

    @property
    def num_states(self) -> int:
        return 1 << (self.K - 1)

    @property
    def tail_bits(self) -> int:
        """Zero bits appended to terminate the trellis at state 0
        (ref: src/util.h:51-58)."""
        return self.K - 1

    @property
    def decision_words(self) -> int:
        """uint32 words per trellis step holding one decision bit per state."""
        return max(1, self.num_states // 32)

    def transmit_bits(self, data_bytes: int) -> int:
        """Total trellis steps for a frame of ``data_bytes`` input bytes
        (ref invariant: src/util.h:25-28)."""
        return data_bytes * 8 + self.tail_bits

    def total_symbols(self, data_bytes: int) -> int:
        return self.transmit_bits(data_bytes) * self.R

    def abs_polys(self) -> tuple[int, ...]:
        return tuple(abs(p) for p in self.polys)

    def inversions(self) -> tuple[bool, ...]:
        return tuple(p < 0 for p in self.polys)

    def expected_bits_table(self) -> np.ndarray:
        """``E[r, j]`` = expected output bit of polynomial ``r`` for encoder
        register value ``j`` (``j = (state << 1) | input_bit``, K bits wide).

        Shape ``[R, 2*S]`` uint8.  This is the generalisation of the
        reference's half-state branch tables built from
        ``parity((2*state) & poly)`` (ref: ka9q_libfec_port/viterbi27_sse2.cpp:61-70)
        to arbitrary (state, input-bit) pairs and inverted polynomials.
        """
        n = 1 << self.K
        j = np.arange(n, dtype=np.uint64)
        out = np.empty((self.R, n), dtype=np.uint8)
        for r, (p, inv) in enumerate(zip(self.abs_polys(), self.inversions())):
            masked = j & np.uint64(p)
            # XOR-fold parity of up-to-24-bit values.
            x = masked
            for shift in (16, 8, 4, 2, 1):
                x = x ^ (x >> np.uint64(shift))
            bits = (x & np.uint64(1)).astype(np.uint8)
            out[r] = bits ^ np.uint8(1 if inv else 0)
        return out


@dataclasses.dataclass(frozen=True)
class NumericSpec:
    """Numeric decoding policy.

    Mirrors the information content of the reference's
    ``Decoder_Config<soft_t, error_t>`` (ref: src/viterbi_configs.h:6-11) and
    ``ViterbiDecoder_Config`` fields:

    * ``soft_high`` / ``soft_low``: rail values bits are mapped to by the
      encoder/ modem.  Branch penalty for one symbol is ``high - sym`` when
      the expected bit is 1 and ``sym - low`` when it is 0, which reproduces
      the XOR-as-conditional-negation metric of the ka9q decoders
      (ref: ka9q_libfec_port/viterbi27_sse2.cpp:137-146) and the absolute
      error metric of the soft configs.
    * ``initial_margin``: how much worse non-start states begin relative to
      the known start state (ref "error margin",
      src/viterbi_configs.h:26-31; ka9q uses 63 / 1000,
      viterbi27_sse2.cpp:46-52, viterbi615_sse2.cpp:33-39).
    * ``renorm_interval``: metrics are renormalised (shift-to-zero by the
      running minimum) unconditionally every this many trellis steps.  The
      reference renormalises *lazily* on a data-dependent threshold
      (ref: viterbi615_sse2.cpp:157-183); a fixed interval is the
      equivalent -- subtracting a constant from every state's metric never
      changes any compare-select decision, so decoded bits are identical as
      long as the accumulator cannot overflow between renorms.
    * ``metric_dtype``: metric *storage* dtype of the large-K kernels
      (``"auto"``, ``"int16"`` or ``"int32"``).  The port's large-K pair
      kernel reads it to pick the JAX package's renormalisation schedule
      (``ops/cuda/large_k2.renorm_schedule``); its storage stays int32.
    """

    name: str
    soft_high: int
    soft_low: int
    initial_margin: int
    renorm_interval: int = 0  # 0 = never (int32 headroom is enough)
    metric_dtype: str = "auto"

    @property
    def symbol_span(self) -> int:
        return self.soft_high - self.soft_low

    def max_branch_error(self, R: int) -> int:
        """Worst-case per-step branch metric (ref: soft_decision_max_error,
        src/viterbi_configs.h:25)."""
        return self.symbol_span * R


def ka9q_offset_binary_spec() -> NumericSpec:
    """Offset-binary u8 symbols {0, 255}, the ka9q convention
    (ref: src/viterbi_configs.h:15-20)."""
    return NumericSpec(name="ka9q_offset_binary", soft_high=255, soft_low=0, initial_margin=1000)


def soft16_spec(R: int) -> NumericSpec:
    """Soft-decision {-127, +127} with x5 margin
    (ref: src/viterbi_configs.h:22-35)."""
    return NumericSpec(name="soft16", soft_high=127, soft_low=-127, initial_margin=254 * R * 5)


def soft8_spec(R: int) -> NumericSpec:
    """Soft-decision {-3, +3} with x2 margin (ref: src/viterbi_configs.h:37-50)."""
    return NumericSpec(name="soft8", soft_high=3, soft_low=-3, initial_margin=6 * R * 2)


def hard8_spec(R: int) -> NumericSpec:
    """Hard-decision {-1, +1} with x3 margin (ref: src/viterbi_configs.h:52-65)."""
    return NumericSpec(name="hard8", soft_high=1, soft_low=-1, initial_margin=2 * R * 3)


# The reference's six-config benchmark matrix (ref: src/main.cpp:363-419).
VITERBI27 = CodeSpec("viterbi27", K=7, R=2, polys=(0o155, 0o117))          # {0x6d, 0x4f}
VITERBI47 = CodeSpec("viterbi47", K=7, R=4, polys=(121, 117, 91, 111))
VITERBI29 = CodeSpec("viterbi29", K=9, R=2, polys=(0x1AF, 0x11D))
VITERBI49 = CodeSpec("viterbi49", K=9, R=4, polys=(501, 441, 331, 315))
VITERBI615 = CodeSpec(
    "viterbi615", K=15, R=6,
    polys=(0o42631, 0o47245, 0o56507, 0o73363, 0o77267, 0o64537),          # Cassini
)
VITERBI224 = CodeSpec("viterbi224", K=24, R=2, polys=(0o62650457, 0o62650455))  # ICE

STANDARD_CODES: tuple[CodeSpec, ...] = (
    VITERBI27, VITERBI47, VITERBI29, VITERBI49, VITERBI615, VITERBI224,
)

# Benchmark frame sizes in data bytes per config (ref: src/main.cpp:366-414).
BENCH_FRAME_BYTES: dict[str, int] = {
    "viterbi27": 1024,
    "viterbi47": 1024,
    "viterbi29": 512,
    "viterbi49": 512,
    "viterbi615": 256,
    "viterbi224": 8,
}
