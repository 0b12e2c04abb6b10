"""ka9q_viterbi_comparison_tpu_torch: the PyTorch/CUDA port of
``ka9q_viterbi_comparison_tpu``.

The same codes, numeric specs and reset/update/chainback decoder lifecycle,
written in PyTorch, with the JAX package's Pallas kernels replaced by CUDA
kernels written by hand for Hopper (``csrc/``, built by ``nvcc`` at first
use).  Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU, where each kernel's plain PyTorch version runs instead.
The port imports neither ``jax`` nor the JAX package.
"""

from .configs import (
    BENCH_FRAME_BYTES,
    STANDARD_CODES,
    VITERBI27,
    VITERBI29,
    VITERBI47,
    VITERBI49,
    VITERBI224,
    VITERBI615,
    CodeSpec,
    NumericSpec,
    hard8_spec,
    ka9q_offset_binary_spec,
    soft8_spec,
    soft16_spec,
)
from .models.decoder import ViterbiDecoder, decode_frames
from .models.functional import decode_fn, decode_symbols
from .models.streaming import StreamingDecoder

__version__ = "0.1.0"

__all__ = [
    "CodeSpec",
    "NumericSpec",
    "ViterbiDecoder",
    "StreamingDecoder",
    "decode_frames",
    "decode_fn",
    "decode_symbols",
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
    "__version__",
]
