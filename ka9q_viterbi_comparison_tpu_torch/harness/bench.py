"""Phase-timed benchmarking.

Port of ``ka9q_viterbi_comparison_tpu/harness/bench.py``.  It reproduces the
reference's measurement methodology (ref: src/main.cpp:239-282): each
iteration times the three lifecycle phases separately -- reset /
update(symbols) / chainback -- and the loop runs until BOTH a wall-clock
budget and a minimum sample count are exceeded (ref: src/main.cpp:257-259;
defaults 1.0 s / 8 samples, src/main.cpp:300-310).  Raw per-iteration
nanosecond samples are kept, not aggregates (ref: src/main.cpp:99-108);
statistics happen downstream in the analysis scripts exactly as in the
reference.  The batch axis B means one iteration decodes B frames, so the JSON
bookkeeping counts B x frame sizes -- the schema stays valid for the
reference's analysis scripts.

How a sample is timed.  On the card a phase sample is the time between two
``torch.cuda.Event`` records around a chain of ``k`` executions of the phase
on the current stream, divided by ``k``: the update chain feeds each link's
metrics to the next, the traceback chain starts each link from the end state
``out[0, -1]`` of the one before, and no link waits for the host
(``dispatch.phase_fns``).  ``k`` is chosen once per row from one probed
execution, so that a chain lasts a few milliseconds: enough for the events'
resolution and the launch gaps of a short phase to vanish in the quotient.
With ``device="cpu"`` the same chains are timed with ``perf_counter_ns``.

What of the JAX harness was left out, and why.  Its samples are differences
of two chain lengths, each end the minimum of three raw timings, its chains
grow up to 1024 links by powers of two, and a sample whose difference came
out at or below zero is thrown away and retried with a doubled chain.  All
of that exists to cancel the constant cost and the jitter of a transport
that acknowledges work before it has run.  CUDA events are recorded by the
device itself, in stream order, so there is no constant to cancel and no
early acknowledgement: one chain, its time over its links, is the
measurement.

The ``"native"`` backend is the host C++ decoder (``utils/native.py``), one
``HostDecoder`` a frame: its phases run on the host and are timed with
``perf_counter_ns``, one link a chain, as the JAX harness times them.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..configs import CodeSpec, NumericSpec
from ..models.decoder import as_symbols, resolve_device
from ..ops import acs, chainback as cb
from ..utils.bits import count_bit_errors

__all__ = ["PhaseSample", "BenchResult", "run_phase_bench", "time_update_marginal",
           "time_update_phase", "sync"]

BACKENDS = ("cuda", "torch", "native")
CHAIN_TARGET_NS = 4e6  # a chain should last about this long
MAX_LINKS = 64


def sync(tree=None):
    """Wait until the card has finished everything queued so far
    (``torch.cuda.synchronize``); returns ``tree``.  Without a card there is
    nothing to wait for: CPU tensors are complete when a call returns."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return tree


def _timed_ns(fn, device: torch.device):
    """``(elapsed ns, fn())``: CUDA events on the current stream of a card,
    the host's monotonic clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e6, out
    t0 = time.perf_counter_ns()
    out = fn()
    return time.perf_counter_ns() - t0, out


@dataclasses.dataclass
class PhaseSample:
    init_ns: int
    update_ns: int
    chainback_ns: int


@dataclasses.dataclass
class BenchResult:
    name: str
    code: CodeSpec
    batch: int
    frame_bytes: int
    sampling_time: float
    minimum_samples: int
    samples: list[PhaseSample]
    total_bit_errors: int

    @property
    def total_input_bytes(self) -> int:
        return self.batch * self.frame_bytes

    @property
    def total_transmit_bits(self) -> int:
        return self.batch * self.code.transmit_bits(self.frame_bytes)

    @property
    def total_output_symbols(self) -> int:
        return self.batch * self.code.total_symbols(self.frame_bytes)

    @property
    def total_bits(self) -> int:
        return self.total_input_bytes * 8

    def to_json_obj(self) -> dict:
        """Reference-schema JSON object (ref: print_test, src/main.cpp:80-118)."""
        return {
            "name": self.name,
            "K": self.code.K,
            "R": self.code.R,
            "poly": list(self.code.polys),
            "total_input_bytes": self.total_input_bytes,
            "total_transmit_bits": self.total_transmit_bits,
            "total_output_symbols": self.total_output_symbols,
            "sampling_time": self.sampling_time,
            "minimum_samples": self.minimum_samples,
            "total_samples": len(self.samples),
            "init_ns": [s.init_ns for s in self.samples],
            "update_ns": [s.update_ns for s in self.samples],
            "chainback_ns": [s.chainback_ns for s in self.samples],
            "total_bits": self.total_bits,
            "total_bit_errors": self.total_bit_errors,
            "bit_error_rate": self.total_bit_errors / float(self.total_bits),
        }


def _phases_for_backend(code: CodeSpec, numeric: NumericSpec, backend: str, num_data_bits: int,
                        batch: int | None = None, device: torch.device | str = "cuda"):
    """``(init_fn, update_fn, chainback_fn, prepare_fn, make_chainback_chain,
    make_update_chain)`` for a backend: ``"cuda"`` the kernels' phases
    (``dispatch.phase_fns``), ``"torch"`` the portable path."""
    from ..ops.cuda import dispatch

    if backend == "native":
        return _native_phases(code, numeric, num_data_bits)
    device = resolve_device(device)
    if backend == "cuda":
        return dispatch.phase_fns(code, numeric, num_data_bits, batch, device)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")

    # Mid-size trellises run the rotating-address formulation and its
    # position-packed traceback, as the JAX package's portable family does;
    # the penalties are always built inside the loop (a whole frame's penalty
    # tensor is O(T * B * 2S)).
    use_rot = 10 <= code.K <= 15

    def update_fn(metrics, symbols):
        if use_rot:
            return acs.acs_update_rotating(code, numeric, metrics, symbols, 0)
        return acs.acs_update(code, numeric, metrics, symbols, True)

    def _cb(words, endstate):
        return cb.chainback(code, words, num_data_bits, endstate, use_rot)

    def init_fn(batch: int):
        return acs.init_metrics(code, numeric, batch, device=device)

    def chainback_fn(words):
        return _cb(words, 0)

    def prepare_fn(symbols):
        return as_symbols(symbols, device).contiguous()

    return (init_fn, update_fn, chainback_fn, prepare_fn,
            *dispatch.make_chains(update_fn, _cb))


def _native_phases(code: CodeSpec, numeric: NumericSpec, num_data_bits: int):
    """The host decoder's phases: ``init_fn(batch)`` resets one
    ``HostDecoder`` a frame (made at the first call), ``update_fn`` feeds each
    its frame's symbols, ``chainback_fn`` stacks their bytes.  The decoders
    are the state; ``metrics`` and ``words`` are ``None``."""
    from ..ops.cuda import dispatch
    from ..utils import native

    decoders: list = []

    def init_fn(batch: int):
        if not decoders:
            decoders.extend(native.HostDecoder(code, numeric, max_steps=0) for _ in range(batch))
        for d in decoders:
            d.reset()

    def update_fn(metrics, sym_np):
        for d, s in zip(decoders, sym_np):
            d.update(s)
        return None, None, None

    def _cb(words, endstate):
        return np.stack([d.chainback(num_data_bits // 8, int(endstate))[0] for d in decoders])

    def chainback_fn(words):
        return _cb(words, 0)

    def prepare_fn(symbols):
        return np.ascontiguousarray(symbols.cpu().numpy().reshape(symbols.shape[0], -1),
                                    dtype=np.int32)

    return (init_fn, update_fn, chainback_fn, prepare_fn, *dispatch.make_chains(update_fn, _cb))


def _links_for(per_link_ns: float) -> int:
    return max(1, min(MAX_LINKS, math.ceil(CHAIN_TARGET_NS / max(per_link_ns, 1.0))))


def run_phase_bench(
    code: CodeSpec,
    numeric: NumericSpec,
    data: np.ndarray,
    symbols,
    name: str = "gpu_torch",
    backend: str = "torch",
    sampling_time: float = 1.0,
    minimum_samples: int = 8,
    device: torch.device | str = "cuda",
) -> BenchResult:
    """Benchmark one (code, numeric, backend) combo over pre-encoded frames.

    ``data``: ``[B, N]`` uint8 originals; ``symbols``: ``[B, T*R]`` (numpy or
    tensor, any device; staged on ``device`` outside the timed phases).
    """
    device = resolve_device(device)
    B, n_bytes = data.shape
    symbols = as_symbols(symbols, device).reshape(B, -1, code.R)
    num_data_bits = n_bytes * 8
    (init_fn, update_fn, chainback_fn, prepare_fn, make_cb_chain,
     make_up_chain) = _phases_for_backend(code, numeric, backend, num_data_bits, B, device)
    prepared = prepare_fn(symbols)  # the backend's own layout, untimed
    if backend == "native":
        device = torch.device("cpu")  # the host's clock

    # Warm-up (on the card: the kernels' build and first launch), and the
    # probe that sizes the chains (the host decoder: one link a chain).
    metrics = init_fn(B)
    _, words, _ = update_fn(metrics, prepared)
    chainback_fn(words)
    sync()
    n_init = 4
    n_up = n_cb = 1
    if backend != "native":
        n_up = _links_for(_timed_ns(lambda: update_fn(metrics, prepared), device)[0])
        n_cb = _links_for(_timed_ns(lambda: chainback_fn(words), device)[0])
    up_chain, cb_chain = make_up_chain(n_up), make_cb_chain(n_cb)

    def init_chain():
        for _ in range(n_init):
            m = init_fn(B)
        return m

    samples: list[PhaseSample] = []
    t_start = time.perf_counter()
    while (time.perf_counter() - t_start) < sampling_time or len(samples) < minimum_samples:
        ti, metrics = _timed_ns(init_chain, device)
        tu, (_, words) = _timed_ns(lambda: up_chain(metrics, prepared), device)
        tc, _ = _timed_ns(lambda: cb_chain(words), device)
        samples.append(PhaseSample(max(int(ti / n_init), 1), max(int(tu / n_up), 1),
                                   max(int(tc / n_cb), 1)))

    # The timing chains feed metrics forward and trace back from other end
    # states; the correctness check decodes once more from reset metrics.
    _, words, _ = update_fn(init_fn(B), prepared)
    out = sync(chainback_fn(words))
    errors = count_bit_errors(out, data)
    return BenchResult(
        name=name,
        code=code,
        batch=B,
        frame_bytes=n_bytes,
        sampling_time=sampling_time,
        minimum_samples=minimum_samples,
        samples=samples,
        total_bit_errors=errors,
    )


def time_update_marginal(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    backend: str = "cuda",
    n_chain: int = 5,
    iters: int = 3,
    device: torch.device | str = "cuda",
) -> float:
    """Device throughput (symbols/s) of the symbol-update phase: the median
    over ``iters`` of the time of a chain of ``n_chain`` updates, each on the
    metrics of the one before, over its links.  ``symbols``: ``[B, T, R]`` or
    ``[B, T*R]``."""
    device = resolve_device(device)
    B = symbols.shape[0]
    symbols = as_symbols(symbols, device).reshape(B, -1, code.R)
    T = symbols.shape[1]
    init_fn, _, _, prepare_fn, _, make_up_chain = _phases_for_backend(
        code, numeric, backend, 8, B, device)
    prepared = prepare_fn(symbols)
    metrics = init_fn(B)
    chain = make_up_chain(n_chain)
    chain(metrics, prepared)  # warm-up
    sync()
    per_link = [_timed_ns(lambda: chain(metrics, prepared), device)[0] / n_chain
                for _ in range(max(iters, 3))]
    return B * T * code.R / (float(np.median(per_link)) * 1e-9)


def time_update_phase(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols,
    iters: int = 5,
    backend: str = "torch",
    device: torch.device | str = "cuda",
) -> float:
    """Median symbol-update throughput (symbols/s) over ``iters`` timed runs
    of one update each."""
    device = resolve_device(device)
    B = symbols.shape[0]
    symbols = as_symbols(symbols, device).reshape(B, -1, code.R)
    T = symbols.shape[1]
    init_fn, update_fn, _, prepare_fn, _, _ = _phases_for_backend(
        code, numeric, backend, 8, B, device)
    prepared = prepare_fn(symbols)
    metrics = init_fn(B)
    update_fn(metrics, prepared)  # warm-up
    sync()
    times = [_timed_ns(lambda: update_fn(metrics, prepared), device)[0] for _ in range(iters)]
    return B * T * code.R / (float(np.median(times)) * 1e-9)
