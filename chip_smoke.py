"""Drive the PyTorch/CUDA port's decode paths on one GPU and check them.

    python3 chip_smoke.py

Builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, started
together), holds each of the sixteen kernels against its plain PyTorch version
on the card (the in-place pair and the tracebacks in every form: K=3..15,
R=1..6, every kind of ``t0`` and ``t_real``, ragged batches, codes that do not
tap both register ends, chained halves; the state-order ACS through both of
its entry points at K=2..10, R=1..6, batches of 1, 33 and 130;
``acs_update_large`` in each form of its plan: on chip at Cassini, octets at
ICE, streaming at K=10 R=7, with its launcher calls counted; the large-K
launch plans from entry metrics at the int32 limit; the two K > 15 walks,
the table walk on the f8 and f4 tables and ``chainback_tb`` on the words that
the depth-4 kernels' comparisons at ICE B=8 wrote, and at K=16-17; the u8
replicas' kernel, ``quantized_update`` and ``spiral_update``, at K=3, 5, 7
and 9, an inverted SPIRAL polynomial, batches 1, 33 and 130, random entry
metrics and all-noise symbols on which SPIRAL's renormalisation fires; the
state-sharded trellis step, ``sharded_acs_scan``, at K=9 on state 2, 4 and 8
and K=15 and K=17 on state 4, batches 1, 3 and 8, with and without words,
from entry metrics within 600 of the int32 limit, the scan in both of its
metric layouts (interleaved, as in one process, and half-major, as across
processes), each also one step through the one-step entry point
``sharded_acs_step``, and at ICE: the first 3
steps of path 9's state-sharded decode and 2 steps of its state x time
shape; the state-sharded traceback's walk, ``sharded_traceback``, one launch
a decode, and its step kernel, ``sharded_traceback_step``, one launch a step
where a state line spans processes, on the words of each of those scans and
on the whole words of path 9's two ICE decodes; and every output form of the
two tracebacks -- bits of a range of steps, data bytes, into a view with a
row stride, the end state as the argmin of ``[S, B]`` and ``[B, S]``
metrics, a start step a frame -- against the words form and the plain
conversion, at K=7 B=64 and B=512, a K=7 window at an odd ``t0``, K=9 soft16
B=512, Cassini B=64 and B=256 and ICE B=8; and the three whole-frame ACS
kernels -- ``acs_update_tb``, ``acs_update_inplace`` and ``acs_update_tb2``
-- on batch-major views of the inputs of their timing rows, the decoder's
layout, against their contiguous launch), then drives nine paths --
through ``ViterbiDecoder(backend="cuda")``,
``dispatch.phase_fns``, the benchmark runner, ``StreamingDecoder``, the BER
harness and the sharded decodes of ``parallel`` -- each with the launch
counts zeroed just before it and read just after:

* VITERBI27 (K=7, r=1/2) soft8, 1024-byte frames: B=512 (the in-place pair)
  and B=64 (the state-order pair);
* VITERBI615 (K=15, r=1/6, Cassini) soft8, 256-byte frames: B=256 (the
  in-place pair) and B=64 (the on-chip pair kernel, one launch a block of
  steps: whole frames and two blocks of 1031 steps with their odd tails);
* VITERBI224 (K=24, r=1/2, ICE) soft8, 8-byte frames (T = 87) at B=8: the
  depth-4 kernel (ten octets, then the last quad and the three-step
  remainder as one 7-step launch) on whole frames, and in blocks of 41 and
  46 steps, whose remainders of 1 and 2 steps run on the streaming step and
  pair kernels with their entry shift from the last octet launch (no whole
  ICE call reaches them: the blocks are there to keep them on a path);
  ``chainback_tb`` over the batch-major words where they lie;
* the same ICE frames through ``phase_fns``: the update that returns the
  byte-packed f8 walk table (the octet kernel in fields mode, ten octets,
  after the 7 lead steps as one 7-step launch) and the table walk kernel, 8
  steps a fetch; and, asked for 7 of the 8 bytes, the f4 route (a 3-step
  lead);
* VITERBI27 soft8, 1024-byte frames at B=1024 with the in-place route off
  (``KA9Q_TORCH_INPLACE=0`` for this path only): the depth-2 state-order
  kernel ``acs_update_tb2`` and ``chainback_tb``, through the decoder and
  through ``phase_fns`` with its chains of three links;
* the benchmark runner (``harness.runner.run_matrix``, ``backends=["cuda"]``):
  all six codes at its default batches and the reference's frame sizes,
  every numeric spec, 16 rows of reference-schema JSON held to the hard
  rules of ``harness.check_results`` (no sample on the 1 us floor, BER 0,
  the HBM roofline, K=9 chainback at most 1.2x K=7's, and every cell beats
  its reference column), the roofline at every K by the bytes the CUDA
  walk fetches (``check_results.walk_bytes_per_bit``).  The std rule
  (std/mean <= 15 %) is printed, not enforced, since these 0.15 s windows
  of three or more samples are too short for it and the checked-in matrix
  (``data/benchmark_torch.json``) is what must pass it;
* streams through ``StreamingDecoder(backend="cuda")``: VITERBI27 soft8 at
  B=512 (the in-place pair) and B=64 (the state-order pair) in 16 pushes of
  2046 steps, Cassini soft8 at B=256 in 4 pushes of 2044 steps: the released
  bits equal the data, a decoder restored from a checkpoint taken after the
  second push releases the same bits, two noisy pushes equal
  ``backend="torch"``'s; the steady-state push rate and the host's
  microseconds to issue a push beside the batch update rate of the same code
  and batch (a push is the update, which reads the pushed symbols where they
  lie, into the stream's window, the walk that takes the argmin and writes
  the released bits, and the retained rows' copy: its device operations are
  traced at the end);
* the AWGN and replica path: a BER point at VITERBI27 soft16, B=512,
  256-byte frames, 3 dB on the kernels through the curve CLI's own function
  (``harness.ber_curve.main``; coded BER below uncoded); the
  ka9q- and SPIRAL-exact u8 replicas at K=7 and K=9, B=512, 1024-byte AWGN
  frames on the card (the u8 kernel and ``chainback_tb``), their first 8
  frames byte-identical to the CPU's, and (outside the counted run) the
  kernel's metrics and words on the first 64 frames equal to its plain
  version's; the runner's ``cpu_native`` rows (the host C++ decoder) for
  viterbi27 and viterbi615;
* the multi-device paths on in-process meshes on this one card
  (``parallel.Mesh``): frame DP at VITERBI27 soft8, 1024-byte frames, B=512
  and B=64 on frame=4 (the in-place and the state-order pair a shard); time
  blocks of the same frames (padded to 8200 steps) at B=64 on (frame=2,
  time=4) and on time=8, overlap 56 (the in-place pair); the state-sharded
  ICE decode, B=8 8-byte frames on state=4 (87 launches of the shard step,
  one of the walk); the state x time ICE decode of one 64-byte frame on
  (state=4, time=2), overlap 96 (96 warm-up and 364 main launches of the
  step, one walk for both time blocks); a K=9 state-sharded decode of
  65537 noisy 2-byte frames on state=4 (two launches a step: a launch
  takes at most 65535 frames).  Bytes equal the data
  and the unsharded decode, noisy time-block bits the CPU's; each case
  prints its time, its collectives counted by
  ``harness.comms.collective_trace`` held against the analytic model, and
  its launches (the time-block shard body's device operations are traced
  at the end).  One card runs every shard, so the times are the shard
  plumbing's cost, not scaling.

After the paths, the in-place envelope's canary of ``harness/hw_check.py``
(``envelope_row``): VITERBI615 soft8 256-byte noiseless frames at B=512 on
the ``cuda`` backend, which the port keeps on the in-place pair where the
JAX package leaves it (``ROADMAP.md`` section 3): the route, 0 bit errors,
one in-place block's shared memory against the card's opt-in limit, its
launches and its time.  It is held to the data, so it has no plain run.

Then it times the kernels and the decoders' phases with CUDA events (the
two K > 15 walks beside their latency bound: dependent fetches a frame times
the card's dependent-load latency, measured by ``harness.probe_walk``, in
the kernels line as ``latency_bound_ms``; the u8 replicas' update and
decode at K=7 and K=9, B=512, beside the reference decoders' ka9q and
spiral columns; the shard step alone at ICE B=8 on state=4 beside its
bound; the walk alone on path 9's two ICE decodes' words beside its latency
bound, and those decodes split into scan and traceback, with the host's
microseconds a step beside the device's and the idle share of one traced
run), and
times the tracebacks' bits, bytes and argmin forms beside their words
rows, counts their launches by form over the nine paths, and counts the
launches a call of the state-order and large-K updates
(``acs_update_large``: as many as ``large_k.plan`` gives, one a call on
chip), the device operations of a whole-frame decoder update on both routes
and of a steady stream push from a profiler trace, and the glue around the
update kernel (the decoder's update phase less the kernel alone on the
decoder's batch-major inputs).  Every number line carries the card's name and power limit.  The last three lines
are a JSON object listing the kernels, the card's name and power limit, and a
JSON object ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
port's package beside it.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ka9q_viterbi_comparison_tpu_torch import (  # noqa: E402
    CodeSpec,
    STANDARD_CODES,
    VITERBI27,
    VITERBI29,
    VITERBI47,
    VITERBI49,
    VITERBI224,
    VITERBI615,
    BENCH_FRAME_BYTES,
    StreamingDecoder,
    ViterbiDecoder,
    decode_symbols,
    ka9q_offset_binary_spec,
    soft8_spec,
    soft16_spec,
)
from ka9q_viterbi_comparison_tpu_torch import parallel  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.parallel import statewise, timeblock  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.harness import (  # noqa: E402
    ber_curve,
    check_results,
    comms,
    hw_check,
    probe_tb,
    profiling,
    probe_walk,
    runner,
)
from ka9q_viterbi_comparison_tpu_torch.ops import channel, quantized, radix_planes  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    dispatch,
    inplace,
    kernels,
    kernels2,
    large_k,
    large_k2,
    large_k4,
    shard,
    walk,
)
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_bits, encode_frames  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.utils.bits import bits_to_bytes, count_bit_errors  # noqa: E402

SEED = 20261016
FRAME_BYTES = 1024          # K=7 frames
B_INPLACE, B_TB = 512, 64   # K=7 batches
B_TB2 = 1024                # the depth-2 kernel's batch (K <= 9, in-place route off)
CAS_BYTES = 256             # Cassini frames (T = 2062 steps)
B_CAS_INPLACE, B_CAS_LARGE = 256, 64
ICE_BYTES, B_ICE = 8, 8     # ICE frames (T = 87 steps)
# Streams (path 7): (code, batch, steps a push, pushes, the update and walk of
# its route).  K=7 at B=512 in 2046-step pushes is the state size of the JAX
# package's own streaming probe (tools/streaming_probe.py); Cassini pushes are
# whole rotation periods (146 * 14 steps).
STREAMS = ((VITERBI27, 512, 2046, 16, ("acs_update_inplace", "chainback_inplace")),
           (VITERBI27, 64, 2046, 16, ("acs_update_tb", "chainback_tb")),
           (VITERBI615, 256, 2044, 4, ("acs_update_inplace", "chainback_inplace")))
BER_BYTES, B_BER, BER_EBN0 = 256, 512, 3.0  # path 8's BER point, VITERBI27 soft16
U8_HELD = 64  # path 8 holds the replicas' kernel to its plain version on these first frames
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 132 SMs x 64 INT32 lanes x 1.98 GHz: the int32 issue rate of adds, compares
# and selects (the data sheet's 33.5 TOP/s counts a multiply-add as two); every
# operation counted below is one of these.
INT32_OPS_PER_S = 16.73e12

CODE = VITERBI27

SOURCE = {name: "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_small.cu" for name in
          ("acs_update_tb", "chainback_tb", "acs_update_inplace", "chainback_inplace",
           "acs_update_tb2")}
SOURCE.update({name: "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_large.cu" for name in
               ("acs_update_large2", "acs_update_large")})
SOURCE.update({name: "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_large4.cu" for name in
               ("acs_update_large4", "acs_update_large4_fields", "acs_update_large4_fields8")})
SOURCE["chainback_planes"] = "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_walk.cu"
SOURCE.update({name: "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_u8.cu" for name in
               ("quantized_update", "spiral_update")})
SOURCE.update({name: "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_shard.cu" for name in
               ("sharded_acs_scan", "sharded_traceback")})
REPLACES = {
    "acs_update_tb": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py:227",
    "chainback_tb": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py:361",
    "acs_update_inplace": "ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py:468",
    "chainback_inplace": "ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py:630",
    "acs_update_tb2": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels2.py:184",
    "acs_update_large2": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k2.py:340",
    "acs_update_large": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k.py:167",
    "acs_update_large4": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k4.py:358",
    "acs_update_large4_fields": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k4.py:512",
    "acs_update_large4_fields8": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k4.py:669",
    # The table walk replaces no pl.pallas_call: the JAX package runs it as jnp.
    "chainback_planes": "ka9q_viterbi_comparison_tpu/ops/radix_planes.py:299",
    # The u8 replicas replace no pl.pallas_call either: the JAX package runs
    # each as one jax.jit over one lax.scan.
    "quantized_update": "ka9q_viterbi_comparison_tpu/ops/quantized.py:96",
    "spiral_update": "ka9q_viterbi_comparison_tpu/ops/quantized.py:180",
    # The shard step replaces no pl.pallas_call either: the JAX package runs
    # the state-sharded scan as jnp inside a shard_map.
    "sharded_acs_scan": "ka9q_viterbi_comparison_tpu/parallel/statewise.py:90",
    # Nor does the walk: the JAX package's traceback is a lax.scan inside the
    # shard_map.  Its step kernel, sharded_traceback_step, runs only where a
    # state line spans processes, so no path of this one-card script launches
    # it; it is held to its plain version below, outside the kernels line.
    "sharded_traceback": "ka9q_viterbi_comparison_tpu/parallel/statewise.py:120",
}
K10R7_POLYS = (0o1167, 0o1546, 0o1353, 0o1731, 0o1215, 0o1473, 0o1621)  # blocks too small on chip
ICE_LEAD4, ICE_LEAD8 = 3, 7  # (K-1) % 4, and the 8-aligned anchor 23 % 8, at T = 87
# The reference's per-test JSON schema (ref: print_test, src/main.cpp:80-118).
SCHEMA_KEYS = {
    "name", "K", "R", "poly", "total_input_bytes", "total_transmit_bits",
    "total_output_symbols", "sampling_time", "minimum_samples", "total_samples", "init_ns",
    "update_ns", "chainback_ns", "total_bits", "total_bit_errors", "bit_error_rate"}


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def noisy_symbols(numeric, batch, rng, noise, code=CODE, n_bytes=FRAME_BYTES):
    """Encoded random frames plus uniform integer noise in [-noise, noise],
    clipped to the rails: ``(data [B, N] uint8, symbols [B, T, R] int32 on the card)``."""
    data = rng.integers(0, 256, size=(batch, n_bytes), dtype=np.uint8)
    clean = encode_frames(code, numeric, torch.from_numpy(data)).numpy()
    sym = clean + rng.integers(-noise, noise + 1, size=clean.shape) if noise else clean
    sym = np.clip(sym, numeric.soft_low, numeric.soft_high).astype(np.int32)
    return data, torch.from_numpy(sym).cuda().reshape(batch, -1, code.R)


def trb(sym_btr):
    return sym_btr.permute(1, 2, 0).contiguous()


def metrics0(code, numeric, B, state_major=True):
    """Reset metrics on the card: ``[S, B]`` (or ``[B, S]``)."""
    m = torch.full((code.num_states, B), numeric.initial_margin, dtype=torch.int32,
                   device="cuda")
    m[0] = 0
    return m if state_major else m.T.contiguous()


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two int32 tensors read as uint32 words."""
    if torch.equal(a, b):
        return 0
    a = a.cpu().numpy().view(np.uint32).astype(np.int64)
    b = b.cpu().numpy().view(np.uint32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def timed_ms(fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """``timed_ms`` with the calls queued behind a spin kernel
    (``torch.cuda._sleep``, some 25 ms), so that the events bracket the
    calls' device work and not the host's issue of the first call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def once_ms(fn) -> float:
    """One call, no warm-up: the plain versions take seconds and are no
    yardstick of speed, so one reading of each is enough."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def acs_bound_ms(B, T, code=CODE) -> tuple[float, str]:
    """Least time of one ACS sweep: bytes = symbols in + metrics in and out +
    words out; operations per frame and step = the 2^R penalty sums of R
    terms each, then per state 2 adds + compare + select + penalty index +
    packing = 6."""
    S, W, R = code.num_states, code.decision_words, code.R
    nbytes = 4 * B * (T * R + 2 * S + T * W)
    ops = B * T * ((1 << R) * R + 6 * S)
    return bound(nbytes, ops)


def fields_bound_ms(B, T, lead, code) -> tuple[float, str]:
    """Least time of a fields-form update: as ``acs_bound_ms``, but the
    T - lead quad steps write a table of one word per 32 states and step in
    place of words (the lead steps' words are dropped: no bytes), and carry
    the path field with one more select per state and step."""
    S, W, R = code.num_states, code.decision_words, code.R
    nbytes = 4 * B * (T * R + 2 * S + (T - lead) * W)
    ops = B * (T * ((1 << R) * R + 6 * S) + (T - lead) * S)
    return bound(nbytes, ops)


def metric_pass_ms(B, code) -> float:
    """One read and one write of every frame's metrics at the card's memory
    rate: the traffic a large-K kernel pays each time the metrics cross
    device memory."""
    return 2 * 4 * B * code.num_states / HBM_BYTES_PER_S * 1e3


def chainback_bound_ms(B, T, rotated) -> tuple[float, str]:
    """Least time of one traceback: the walk reads one word per step and
    frame (what the data needs), the end state, and writes T/32 words; per
    step 8 operations (word select, bit extract, state update, bit pack),
    3 more for the rotation."""
    nbytes = 4 * B * (T + 1 + -(-T // 32))
    ops = B * T * (11 if rotated else 8)
    return bound(nbytes, ops)


def bound(nbytes, ops) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: int) -> int:
    if err != 0:
        raise SystemExit(f"FAIL {name}: kernel disagrees with its plain version (max_abs_err {err})")
    return err


def form_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two outputs of one shape (bits, bytes or words
    as their integers); a shape mismatch counts as 2^32."""
    if a.shape != b.shape:
        return 1 << 32
    if torch.equal(a, b):
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


FORM_ERRS: dict[str, int] = {"chainback_tb": 0, "chainback_inplace": 0}  # forms held while timing


def form_bound_ms(B, T, rotated, out_bytes, metric_bytes=0) -> tuple[float, str]:
    """``chainback_bound_ms`` with the form's output in place of the words
    (a byte a step, a byte a data byte) and, for the argmin form, the
    frame's metrics read once."""
    nbytes = 4 * B * (T + 1) + out_bytes + metric_bytes
    return bound(nbytes, B * T * (11 if rotated else 8))


def form_rows(tag, rows, name, args, shape):
    """Row 2's or row 4's output forms timed on the arguments of its words
    row (CUDA events, 20 launches after a warm-up), beside their bounds:
    ``bits`` of every step, the data ``bytes``, the bytes from the argmin of
    the frame's ``[S, B]`` metrics."""
    code, dec, end, T = args[:4]
    extra, rotated = args[4:], name == "chainback_inplace"
    fn = kernels.chainback_tb if not rotated else inplace.chainback_inplace
    B, lo = dec.shape[2], code.K - 1
    nb = (T - lo) // 8 * 8
    m = metrics0(code, soft8_spec(code.R), B)
    forms = {}
    for form, call, out_bytes, mb in (
            ("bits", lambda: fn(code, dec, end, T, *extra, "bits", 0, T), B * T, 0),
            ("bytes", lambda: fn(code, dec, end, T, *extra, "bytes", lo, lo + nb), B * nb // 8, 0),
            ("bytes from the argmin",
             lambda: fn(code, dec, None, T, *extra, "bytes", lo, lo + nb, metrics=m),
             B * nb // 8, 4 * B * code.num_states)):
        ms = timed_ms(call, 20)
        bnd = form_bound_ms(B, T, rotated, out_bytes, mb)
        forms[form] = {"ms": ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"[{tag}] {name} {shape} {form} form: kernel {ms:.4f} ms = "
              f"{1e6 * ms / T:.1f} ns a step (words form {rows[name]['ms']:.4f} ms), bound "
              f"{bnd[0]:.6f} ms ({bnd[1]})")
    rows[name]["forms"] = forms


def hold_forms(label, name, code, dec, end, t_real, errs, *extra):
    """Every output and end-state form of the traceback ``name`` (row 2's
    ``chainback_tb`` or row 4's ``chainback_inplace``, ``extra`` its ``t0``)
    against its words form and the plain conversion on the card: the bits of
    steps ``[0, t_real)`` and of a cut that splits chunks, the data bytes,
    bits into a view with a row stride, the end state as the argmin of tied
    metrics ``[S, B]`` and of a ``[B, S]`` view (against the words form from
    ``argmin_states``' end states), and a start step a frame (against the
    words form over the words zeroed from that step on, from state 0).  No
    whole-frame plain run: the words form was held to it already."""
    fn = kernels.chainback_tb if name == "chainback_tb" else inplace.chainback_inplace
    B, K = dec.shape[2], code.K
    bits = dispatch.unpack_bit_words(fn(code, dec, end, t_real, *extra), t_real)
    lo, nb = K - 1, (t_real - K + 1) // 8 * 8
    errs_here = [
        form_err(fn(code, dec, end, t_real, *extra, "bits", 0, t_real), bits),
        form_err(fn(code, dec, end, t_real, *extra, "bits", 5, t_real - 3), bits[:, 5:t_real - 3]),
        form_err(fn(code, dec, end, t_real, *extra, "bytes", lo, lo + nb),
                 bits_to_bytes(bits[:, lo:lo + nb]))]
    big = torch.full((B, t_real + 16), 7, dtype=torch.uint8, device="cuda")
    fn(code, dec, end, t_real, *extra, "bits", 0, t_real, out=big[:, 8:8 + t_real])
    errs_here.append(form_err(big[:, 8:8 + t_real], bits)
                     + int((big[:, :8] != 7).sum() + (big[:, 8 + t_real:] != 7).sum()))
    g = torch.Generator(device="cuda").manual_seed(SEED + t_real)
    m = torch.randint(0, 3, (code.num_states, B), dtype=torch.int32, device="cuda", generator=g)
    phase = (extra[0] + t_real) % (K - 1) if extra else 0
    ref = fn(code, dec, kernels.argmin_states(code, m, phase).reshape(1, B), t_real, *extra)
    for mm in (m, m.T.contiguous().T):
        errs_here.append(form_err(fn(code, dec, None, t_real, *extra, metrics=mm,
                                     metrics_phase=phase)[:-(-t_real // 32)],
                                  ref[:-(-t_real // 32)]))
    errs_here.append(form_err(
        fn(code, dec, None, t_real, *extra, "bytes", lo, lo + nb, metrics=m, metrics_phase=phase),
        bits_to_bytes(dispatch.unpack_bit_words(ref, t_real)[:, lo:lo + nb])))
    del m
    start = torch.randint(0, t_real + 8, (B,), dtype=torch.int32, device="cuda", generator=g)
    live = torch.arange(dec.shape[0], device="cuda")[:, None, None] < start
    zeroed = torch.where(live, dec, torch.zeros((), dtype=dec.dtype, device="cuda"))
    ref = fn(code, zeroed, torch.where(start < t_real, 0, end.reshape(B)).reshape(1, B), t_real,
             *extra)
    del zeroed, live
    nw = -(-t_real // 32)
    errs_here += [form_err(fn(code, dec, end, t_real, *extra, start=start)[:nw], ref[:nw]),
                  form_err(fn(code, dec, end, t_real, *extra, "bits", 0, t_real, start=start),
                           dispatch.unpack_bit_words(ref, t_real))]
    torch.cuda.synchronize()
    err = max(errs_here)
    print(f"{name} {label} output forms (bits, a cut, bytes, a row stride, argmin [S, B] and "
          f"[B, S], argmin bytes, start step words and bits) vs the words form: max_abs_err {err}")
    errs[name] = max(errs[name], check(f"{name} {label} forms", err))


# The plain versions take seconds a frame, so a shape that is both compared
# and timed runs its plain version once: the comparison keeps its inputs and
# the plain version's time here under (kernel, row key), and ``kernel_row``
# times the kernel on those inputs.
COMPARED: dict[tuple, tuple] = {}


def timed_plain(ref, args, kwargs, keep):
    out = []
    ms = once_ms(lambda: out.append(ref(*args, **kwargs)))
    if keep is not None:
        COMPARED[keep] = (args, ms)
    return out[0]


def compare_update(name, fn, ref, args, T, keep=None):
    """Run kernel and plain version on the same inputs; metrics and words
    [:T] must be identical.  Returns (max_abs_err, kernel outputs)."""
    m_k, d_k = fn(*args)
    m_r, d_r = timed_plain(ref, args, {}, keep)
    torch.cuda.synchronize()
    err = max(max_abs_err(m_k, m_r), max_abs_err(d_k[:T], d_r[:T]))
    print(f"{name}: max_abs_err {err}")
    return check(name, err), (m_k, d_k)


def compare_walk(name, fn, ref, args, T, keep=None):
    bits_k, bits_r = fn(*args), timed_plain(ref, args, {}, keep)
    torch.cuda.synchronize()
    nw = -(-T // 32)
    err = max_abs_err(bits_k[:nw], bits_r[:nw])
    print(f"{name}: max_abs_err {err}")
    return check(name, err)


def compare_large(name, fn, ref, args, kwargs=None, keep=None):
    """A large-K update and its plain version: metrics, words and offset
    must be identical.  Returns (max_abs_err, kernel outputs)."""
    kwargs = kwargs or {}
    got = fn(*args, **kwargs)
    want = timed_plain(ref, args, kwargs, keep)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    print(f"{name}: max_abs_err {err} (offset of frame 0: {int(got[-1][0])})")
    return check(name, err), got


def phase_kernels(tag, rng):
    """Each K=7 kernel against its plain version at the main path's shapes."""
    soft8 = soft8_spec(2)
    T = CODE.transmit_bits(FRAME_BYTES)
    errs = {k: 0 for k in _build.LAUNCHES}

    def run_pairs(numeric, B, noise, label, timed=()):
        """All four kernels at one batch; ``timed``: the pair whose timing
        rows are of this shape."""
        _, sym = noisy_symbols(numeric, B, rng, noise)
        s = trb(sym)
        m0 = metrics0(CODE, numeric, B)
        end = torch.from_numpy(rng.integers(0, CODE.num_states, size=(1, B)).astype(np.int32)).cuda()

        def keep(name):
            return (name, None) if name in timed else None

        e, (_, d) = compare_update(f"acs_update_tb {label}", kernels.acs_update_tb,
                                   kernels.acs_update_tb_ref, (CODE, numeric, m0, s, T), T,
                                   keep("acs_update_tb"))
        errs["acs_update_tb"] = max(errs["acs_update_tb"], e)
        e = compare_walk(f"chainback_tb {label}", kernels.chainback_tb, kernels.chainback_tb_ref,
                         (CODE, d, end, T), T, keep("chainback_tb"))
        errs["chainback_tb"] = max(errs["chainback_tb"], e)
        if "chainback_tb" in timed:
            hold_forms(label, "chainback_tb", CODE, d, end, T, errs)
        e, (_, d) = compare_update(f"acs_update_inplace {label}", inplace.acs_update_inplace,
                                   inplace.acs_update_inplace_ref, (CODE, numeric, m0, s, T, 0), T,
                                   keep("acs_update_inplace"))
        errs["acs_update_inplace"] = max(errs["acs_update_inplace"], e)
        e = compare_walk(f"chainback_inplace {label}", inplace.chainback_inplace,
                         inplace.chainback_inplace_ref, (CODE, d, end, T, 0), T,
                         keep("chainback_inplace"))
        errs["chainback_inplace"] = max(errs["chainback_inplace"], e)
        if "chainback_inplace" in timed:
            hold_forms(label, "chainback_inplace", CODE, d, end, T, errs, 0)
        return s, m0

    run_pairs(soft8, B_TB, 4, f"soft8 B={B_TB}", ("acs_update_tb", "chainback_tb"))
    s, m0 = run_pairs(soft8, B_INPLACE, 4, f"soft8 B={B_INPLACE}",
                      ("acs_update_inplace", "chainback_inplace"))
    run_pairs(soft16_spec(2), 128, 160, "soft16 B=128")

    # The in-place pair in two blocks: the second starts at t0 = T1, which is
    # not a multiple of K-1, so metrics and words cross a rotation phase.
    T1 = T // 2
    e1, (m1, d1) = compare_update("acs_update_inplace block 1", inplace.acs_update_inplace,
                                  inplace.acs_update_inplace_ref,
                                  (CODE, soft8, m0, s[:T1].contiguous(), T1, 0), T1)
    e2, (_, d2) = compare_update(f"acs_update_inplace block 2 t0={T1}", inplace.acs_update_inplace,
                                 inplace.acs_update_inplace_ref,
                                 (CODE, soft8, m1, s[T1:].contiguous(), T - T1, T1), T - T1)
    end = torch.zeros((1, B_INPLACE), dtype=torch.int32, device="cuda")
    e3 = compare_walk(f"chainback_inplace window t0={T1}", inplace.chainback_inplace,
                      inplace.chainback_inplace_ref, (CODE, d2, end, T - T1, T1), T - T1)
    hold_forms(f"window t0={T1}", "chainback_inplace", CODE, d2, end, T - T1, errs, T1)
    whole = torch.cat([d1[:T1], d2[:T - T1]])
    e4 = compare_walk("chainback_inplace over both blocks", inplace.chainback_inplace,
                      inplace.chainback_inplace_ref, (CODE, whole, end, T, 0), T)
    errs["acs_update_inplace"] = max(errs["acs_update_inplace"], e1, e2)
    errs["chainback_inplace"] = max(errs["chainback_inplace"], e3, e4)
    print(f"[{tag}] K=7 kernels vs plain versions: all bit-identical")
    return errs


def phase_kernels_large(tag, rng, errs):
    """The large-K pair and step kernels at Cassini and ICE shapes, and the
    K=7 kernels' K=15 shapes (in-place pair at B=256, chainback_tb at B=64),
    each against its plain version."""
    cas, soft8 = VITERBI615, soft8_spec(6)
    T = cas.transmit_bits(CAS_BYTES)

    def note(name, e):
        errs[name] = max(errs[name], e)

    # Cassini soft8 B=64, a whole frame: renormalisation fires after pairs
    # 393 and 787 (rn = 394).
    _, rn = large_k2.renorm_schedule(cas, soft8, T)
    print(f"cassini soft8 T={T}: renormalisation every {rn} pairs, "
          f"{(T // 2) // rn if rn else 0} times a frame")
    _, sym = noisy_symbols(soft8, B_CAS_LARGE, rng, 3, cas, CAS_BYTES)
    m0 = metrics0(cas, soft8, B_CAS_LARGE, state_major=False)
    e, (m64, words, off64) = compare_large(
        f"acs_update_large2 cassini soft8 B={B_CAS_LARGE} T={T}", large_k2.acs_update_large2,
        large_k2.acs_update_large2_ref, (cas, soft8, m0, sym), keep=("acs_update_large2", None))
    note("acs_update_large2", e)
    # B=1 and B=3 of the same frames (a cluster a frame, so the frames of a
    # call are independent; four blocks a frame where B=64 takes two): equal
    # to the B=64 call, which equals the plain version.
    for B in (1, 3):
        got = large_k2.acs_update_large2(cas, soft8, m0[:B].contiguous(), sym[:B].contiguous())
        torch.cuda.synchronize()
        e = max(max_abs_err(a, b[:B]) for a, b in zip(got, (m64, words, off64)))
        print(f"acs_update_large2 cassini soft8 B={B} T={T} vs frames 0..{B - 1} of B="
              f"{B_CAS_LARGE}: max_abs_err {e}")
        note("acs_update_large2", check(f"acs_update_large2 cassini B={B}", e))
        del got
    del m64, off64
    # A block of 788 pairs: the second renormalisation follows the last pair,
    # and shifts the metrics as they leave the on-chip kernel.
    T_last = 4 * rn
    assert large_k2.renorm_schedule(cas, soft8, T_last)[1] == rn
    e, (m_last, _, _) = compare_large(
        f"acs_update_large2 cassini soft8 B={B_CAS_LARGE} T={T_last} (renorm after the last pair)",
        large_k2.acs_update_large2, large_k2.acs_update_large2_ref,
        (cas, soft8, m0, sym[:, :T_last].contiguous()))
    if not bool((m_last.amin(dim=1) == 0).all()):
        raise SystemExit("FAIL: the renormalisation after the last pair was not applied")
    note("acs_update_large2", e)
    del m_last
    # chainback_tb at K=15 over those canonical words.
    end = torch.from_numpy(rng.integers(0, cas.num_states, size=(1, B_CAS_LARGE))
                           .astype(np.int32)).cuda()
    w = words.permute(1, 2, 0).contiguous()
    note("chainback_tb", compare_walk(f"chainback_tb cassini B={B_CAS_LARGE}", kernels.chainback_tb,
                                      kernels.chainback_tb_ref, (cas, w, end, T), T,
                                      ("chainback_tb", "k15")))
    hold_forms(f"cassini B={B_CAS_LARGE}", "chainback_tb", cas, w, end, T, errs)
    del words, w
    # soft16: int32 storage, no renormalisation; time-major words.
    s16 = soft16_spec(6)
    assert large_k2.renorm_schedule(cas, s16, T) == (torch.int32, 0)
    _, sym16 = noisy_symbols(s16, 16, rng, 160, cas, CAS_BYTES)
    e, _ = compare_large("acs_update_large2 cassini soft16 B=16 time-major",
                         large_k2.acs_update_large2, large_k2.acs_update_large2_ref,
                         (cas, s16, metrics0(cas, s16, 16, state_major=False), sym16),
                         {"time_major": True})
    note("acs_update_large2", e)
    # acs_update_large on chip: an odd-length block (half a frame: 1031 steps).
    half = T // 2
    note("acs_update_large", compare_plan(f"cassini soft8 B={B_CAS_LARGE} T={half}", cas, soft8,
                                          m0, sym[:, :half].contiguous(),
                                          keep=("acs_update_large", None)))
    # ICE K=24 (2^23 states) at B=2, T=7: three pairs and the odd tail.
    ice, s8 = VITERBI224, soft8_spec(2)
    sym_ice = torch.from_numpy(rng.integers(-3, 4, size=(2, 7, 2)).astype(np.int32)).cuda()
    m_ice = metrics0(ice, s8, 2, state_major=False) + torch.randint(
        0, 9, (2, ice.num_states), dtype=torch.int32, device="cuda")
    e, _ = compare_large("acs_update_large2 ice B=2 T=7", large_k2.acs_update_large2,
                         large_k2.acs_update_large2_ref, (ice, s8, m_ice, sym_ice))
    note("acs_update_large2", e)
    note("acs_update_large", compare_plan("ice B=2 T=7", ice, s8, m_ice, sym_ice))
    del m_ice
    # acs_update_large streaming: a K=10 R=7 code, whose blocks are too small
    # for the on-chip form (pairs, then the odd step).
    k10, s7 = CodeSpec("k10r7", 10, 7, K10R7_POLYS), soft8_spec(7)
    sym10 = torch.from_numpy(rng.integers(s7.soft_low, s7.soft_high + 1, size=(3, 21, 7))
                             .astype(np.int32)).cuda()
    m10 = torch.from_numpy(rng.integers(3, 60, size=(3, k10.num_states)).astype(np.int32)).cuda()
    note("acs_update_large", compare_plan("k10r7 B=3 T=21", k10, s7, m10, sym10,
                                          keep=("acs_update_large", "stream")))
    # Both at the ICE decode path's own shapes: B=8, 87 steps, reset metrics.
    _, sym_ice = noisy_symbols(s8, B_ICE, rng, 3, ice, ICE_BYTES)
    m_ice = metrics0(ice, s8, B_ICE, state_major=False)
    T_ice = sym_ice.shape[1]
    e, _ = compare_large(f"acs_update_large2 ice B={B_ICE} T={T_ice}", large_k2.acs_update_large2,
                         large_k2.acs_update_large2_ref, (ice, s8, m_ice, sym_ice),
                         keep=("acs_update_large2", "ice"))
    note("acs_update_large2", e)
    note("acs_update_large", compare_plan(f"ice B={B_ICE} T={T_ice}", ice, s8, m_ice, sym_ice,
                                          keep=("acs_update_large", "ice")))
    # The one-step tail at path 3's shape (the remainder of its 41-step block).
    note("acs_update_large", compare_plan(f"ice B={B_ICE} T=1", ice, s8, m_ice,
                                          sym_ice[:, :1].contiguous(),
                                          keep=("acs_update_large", "ice_tail")))
    del m_ice, sym_ice
    # The in-place pair at K=15, B=256, a whole frame.
    _, sym = noisy_symbols(soft8, B_CAS_INPLACE, rng, 3, cas, CAS_BYTES)
    s = trb(sym)
    m0 = metrics0(cas, soft8, B_CAS_INPLACE)
    e, (_, d) = compare_update(f"acs_update_inplace cassini B={B_CAS_INPLACE}",
                               inplace.acs_update_inplace, inplace.acs_update_inplace_ref,
                               (cas, soft8, m0, s, T, 0), T, ("acs_update_inplace", "k15"))
    note("acs_update_inplace", e)
    end = torch.zeros((1, B_CAS_INPLACE), dtype=torch.int32, device="cuda")
    note("chainback_inplace", compare_walk(f"chainback_inplace cassini B={B_CAS_INPLACE}",
                                           inplace.chainback_inplace,
                                           inplace.chainback_inplace_ref,
                                           (cas, d, end, T, 0), T, ("chainback_inplace", "k15")))
    hold_forms(f"cassini B={B_CAS_INPLACE}", "chainback_inplace", cas, d, end, T, errs, 0)
    near_limit(rng, errs)
    torch.cuda.empty_cache()
    print(f"[{tag}] large-K kernels and K=15 shapes vs plain versions: all bit-identical")


def compare_plan(label, code, numeric, m, sym, keep=None):
    """``acs_update_large`` against its plain version, with one launcher
    call (counted as ``acs_update_large``) a segment of its plan.  Returns
    the max_abs_err."""
    p = large_k.plan(code, m.shape[0], sym.shape[1])
    n = _build.LAUNCHES["acs_update_large"]
    e, _ = compare_large(f"acs_update_large {label} ({p.form}: {p.launches} kernel launches "
                         f"planned)", large_k.acs_update_large, large_k.acs_update_large_ref,
                         (code, numeric, m, sym), keep=keep)
    calls = _build.LAUNCHES["acs_update_large"] - n
    if calls != len(p.segments):
        raise SystemExit(f"FAIL acs_update_large {label}: {calls} launcher calls, planned "
                         f"{len(p.segments)}")
    return e


def near_limit(rng, errs):
    """The large-K updates from entry metrics at the int32 limit, through
    every route of their launch plans (``probe_tb.near_limit_cases``), each
    against its plain version, which shifts them to zero first as the JAX
    package does: a call whose first launch skipped that shift would wrap."""
    for mod, name, args in probe_tb.near_limit_cases(rng):
        e, _ = compare_large(f"{name} {args[0].name} T={args[3].shape[1]} lead={args[4:]} entry "
                             f"metrics near the int32 limit", getattr(mod, name),
                             getattr(mod, name + "_ref"), args)
        errs[name] = max(errs[name], e)


def phase_kernels_quad(tag, rng, errs):
    """The depth-4 kernel (octets and a lone quad) in its three forms
    (words, f4 table, f8 table) and the pair kernel's G_2 planes, each
    against its plain version: at the ICE paths' own shapes, at ICE with
    soft16 symbols so that every renormalisation cadence fires (one inside
    an octet), at the remainders 0-3, and at a small K (time-major words,
    R=1)."""
    ice, s8, s16 = VITERBI224, soft8_spec(2), soft16_spec(2)
    forms = ("acs_update_large4", "acs_update_large4_fields", "acs_update_large4_fields8")

    def note(name, e):
        errs[name] = max(errs[name], e)

    def three(label, code, numeric, m, sym, leads=(ICE_LEAD4, ICE_LEAD8), timed=False):
        out = {}
        for name, lead in zip(forms, ((), (leads[0],), (leads[1],))):
            e, got = compare_large(f"{name} {label}", getattr(large_k4, name),
                                   getattr(large_k4, name + "_ref"), (code, numeric, m, sym, *lead),
                                   keep=(name, None) if timed else None)
            note(name, e)
            out[name] = got[0]
            if timed:
                WALK_INPUTS[name] = got[1]
            del got
            torch.cuda.empty_cache()
        return out

    # The ICE paths' shapes: B=8, T=87, soft8 (no renormalisation).
    _, sym = noisy_symbols(s8, B_ICE, rng, 3, ice, ICE_BYTES)
    T = sym.shape[1]
    assert large_k4.renorm_schedule4(ice, s8, T)[1] == 0
    three(f"ice soft8 B={B_ICE} T={T}", ice, s8, metrics0(ice, s8, B_ICE, state_major=False), sym,
          timed=True)
    # Remainders 1, 2 and 0 after ten octets and a lone quad (T=87 has 3),
    # and 3 after ten octets alone (T=83), from lifted metrics.
    m_lift = metrics0(ice, s8, 2, state_major=False) + torch.randint(
        0, 9, (2, ice.num_states), dtype=torch.int32, device="cuda")
    for t in (85, 86, 84, 83):
        e, _ = compare_large(f"acs_update_large4 ice soft8 B=2 T={t}", large_k4.acs_update_large4,
                             large_k4.acs_update_large4_ref,
                             (ice, s8, m_lift, sym[:2, :t].contiguous()))
        note("acs_update_large4", e)
    del m_lift
    # soft16: every 7 quads (21 quads: the shift after quad 6 falls inside
    # the octet of quads 6-7, the third follows the lone last quad and runs
    # frame_sub_kernel) and every 3 quad pairs (octets).
    assert large_k4.renorm_schedule4(ice, s16, T)[1] == 7
    assert large_k4.renorm_schedule4(ice, s16, T, None, 8)[1] == 3
    _, sym16 = noisy_symbols(s16, 2, rng, 160, ice, ICE_BYTES)
    finals = three(f"ice soft16 B=2 T={T} (renormalising)", ice, s16,
                   metrics0(ice, s16, 2, state_major=False), sym16)
    if not bool((finals["acs_update_large4_fields"].amin(dim=1) == 0).all()):
        raise SystemExit("FAIL: the renormalisation after the last quad was not applied")
    del finals
    # A small trellis: K=12 r=1/2 at B=64, time-major words; K=13 r=1.
    k12 = CodeSpec("k12r2", 12, 2, (0o6731, 0o5247))
    _, sym12 = noisy_symbols(s8, 64, rng, 3, k12, 10)
    m12 = metrics0(k12, s8, 64, state_major=False)
    e, _ = compare_large(f"acs_update_large4 k12 B=64 T={sym12.shape[1]} time-major",
                         large_k4.acs_update_large4, large_k4.acs_update_large4_ref,
                         (k12, s8, m12, sym12), {"time_major": True})
    note("acs_update_large4", e)
    three(f"k12 B=64 T={sym12.shape[1]}", k12, s8, m12, sym12, (11 % 4, 11 % 8))
    k13 = CodeSpec("k13r1", 13, 1, (0o16731,))
    _, sym13 = noisy_symbols(soft8_spec(1), 16, rng, 3, k13, 11)
    three(f"k13 r=1 B=16 T={sym13.shape[1]}", k13, soft8_spec(1),
          metrics0(k13, soft8_spec(1), 16, state_major=False), sym13, (0, 4))
    # The pair kernel's G_2 planes: against its plain version (a gather from
    # the words) and against the v=1 combine of ``build_plane_tables``.
    e, (_, words, g2, _) = compare_large(
        "acs_update_large2 want_g2 k12 B=64", large_k2.acs_update_large2,
        large_k2.acs_update_large2_ref, (k12, s8, m12, sym12), {"want_g2": True})
    combine = radix_planes.build_plane_tables(k12, words.transpose(0, 1), 0)["g2"]
    e = max(e, check("acs_update_large2 want_g2 vs the v=1 combine",
                     max_abs_err(g2.transpose(0, 1).contiguous(), combine)))
    note("acs_update_large2", e)
    torch.cuda.empty_cache()
    print(f"[{tag}] depth-4 kernels (words, f4, f8) and G_2 planes vs plain versions: "
          f"all bit-identical")


# The depth-4 kernels' outputs at the ICE paths' shape (B=8, T=87, soft8),
# kept by their comparisons for the walks': the batch-major words and the f4
# and f8 tables.
WALK_INPUTS: dict[str, torch.Tensor] = {}
ICE_ANCHOR = 23  # K-1: the table walk stops at the first kept data bit
K16, K17 = probe_walk.K16, probe_walk.K17


def phase_kernels_walk(tag, rng, errs):
    """The two K > 15 walks against their plain versions.  The table walk on
    the f8 and f4 tables that the ICE comparisons of the fields forms wrote
    (anchor 23, as ``phase_fns`` walks them; bytes, bits and end state, from
    an int32 end state a frame and from a uint8 0-d one, the form a timing
    chain passes on), and on tables of random K=17 words whose plans end in
    width 4, 2 and 1 windows; ``chainback_tb`` (the words walk) on the ICE
    comparison's batch-major words where they lie and on random K=16 words
    in both layouts.  The ICE calls' inputs and plain times are kept for the timing
    rows: no new whole-frame plain run."""
    ice, B = VITERBI224, B_ICE
    nbits = ICE_BYTES * 8

    def note(name, label, got, want):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        e = max(max_abs_err(a.to(torch.int32), b.to(torch.int32)) for a, b in zip(got, want))
        print(f"{name} {label}: max_abs_err {e}")
        errs[name] = max(errs[name], check(f"{name} {label}", e))

    end = torch.from_numpy(rng.integers(0, ice.num_states, size=B).astype(np.int32)).cuda()
    end_u8 = torch.tensor(201, dtype=torch.uint8, device="cuda")
    for key, form, lead, width in ((None, "acs_update_large4_fields8", ICE_LEAD8, 8),
                                   ("f4", "acs_update_large4_fields", ICE_LEAD4, 4)):
        table = WALK_INPUTS.pop(form)
        tabs = {f"f{width}": table[(ICE_ANCHOR - lead) // width:]}
        label = f"ice f{width} B={B} anchor {ICE_ANCHOR}"
        args = (ice, None, tabs, nbits, end, ICE_ANCHOR)
        got = walk.chainback_planes(*args)
        note("chainback_planes", label, got,
             timed_plain(walk.chainback_planes_ref, args, {}, ("chainback_planes", key)))
        note("chainback_planes", f"{label} bits and end state",
             walk.chainback_plane_bits(*args), radix_planes.chainback_plane_bits(*args))
        args = (ice, None, tabs, nbits, end_u8, ICE_ANCHOR)
        note("chainback_planes", f"{label} uint8 end state", walk.chainback_planes(*args),
             walk.chainback_planes_ref(*args))
        del table
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for T, anchor, width in ((83, 16, 8), (45, 16, 8), (83, 0, 4), (86, 0, 8)):
        w_tm = probe_walk.random_words(K17, T, 5, g)
        tabs = radix_planes.build_plane_tables(K17, w_tm, anchor, None, width)
        nb = (T - 16) // 8 * 8
        e5 = end[:5].contiguous() & (K17.num_states - 1)
        note("chainback_planes", f"k17 B=5 T={T} anchor {anchor} width {width}",
             walk.chainback_plane_bits(K17, w_tm, tabs, nb, e5, anchor),
             radix_planes.chainback_plane_bits(K17, w_tm, tabs, nb, e5, anchor))
    words = WALK_INPUTS.pop("acs_update_large4")  # [B, T, W]
    T = words.shape[1]
    args = (ice, words.permute(1, 2, 0), end.reshape(1, B), T)
    note("chainback_tb", f"ice B={B} T={T} (batch-major words in place)",
         kernels.chainback_tb(*args),
         timed_plain(kernels.chainback_tb_ref, args, {}, ("chainback_tb", "ice")))
    hold_forms(f"ice B={B} T={T}", "chainback_tb", *args, errs)
    w16 = probe_walk.random_words(K16, 50, 3, g).transpose(0, 1).contiguous()  # [B, T, W]
    e16 = end[:3].reshape(1, 3) & (K16.num_states - 1)
    for dec in (w16.permute(1, 2, 0), w16.permute(1, 2, 0).contiguous()):
        note("chainback_tb", f"k16 B=3 T=50 {'contiguous' if dec.is_contiguous() else 'view'}",
             kernels.chainback_tb(K16, dec, e16, 50), kernels.chainback_tb_ref(K16, dec, e16, 50))
    torch.cuda.empty_cache()
    print(f"[{tag}] the K > 15 walks vs plain versions: all bit-identical")


def u8_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two uint8 tensors."""
    return 0 if torch.equal(a, b) else int((a.int() - b.int()).abs().max())


def hold_u8(name, label, code, m0, sym, spiral, errs) -> torch.Tensor:
    """The replicas' route (``quantized._update``: the kernel on the card)
    against its plain version ``quantized._u8_update`` on the same inputs:
    metrics and all ``Tp`` rows of words (zero past T).  Returns the
    kernel's metrics."""
    m_k, w_k = quantized._update(code, m0, sym, spiral)
    m_r, w_r = quantized._u8_update(code, m0, sym, spiral)
    torch.cuda.synchronize()
    e = max(u8_err(m_k, m_r), max_abs_err(w_k, w_r))
    print(f"{name} {label}: max_abs_err {e}")
    errs[name] = max(errs[name], check(f"{name} {label}", e))
    return m_k


_K5, _K3 = CodeSpec("k5r2", 5, 2, (0o23, 0o35)), CodeSpec("k3r2", 3, 2, (0o7, 0o5))
# The u8 kernel's comparison set: (code, SPIRAL?) at each (B, T).  An inverted
# polynomial (SPIRAL's tables carry it) and two codes below 32 states (lanes
# past S copy states); T of 45 and 301, no multiple of the 32-step stage.
U8_SMALL = ((VITERBI27, False), (VITERBI27, True), (VITERBI29, False), (VITERBI29, True),
            (CodeSpec("v27inv", 7, 2, (0o155, -0o117)), True), (_K5, False), (_K5, True),
            (_K3, False), (_K3, True))
U8_SMALL_SHAPES = ((1, 45), (33, 301), (130, 64))
# Update Msym/s of the reference's own ka9q and spiral decoders (BASELINE.md:23,25).
BASELINE_MSYM = {"viterbi27": {"ka9q": 465, "spiral": 457},
                 "viterbi29": {"ka9q": 152, "spiral": 137}}


def phase_kernels_u8(tag, rng, errs):
    """The u8 replicas' kernel (``quantized_update``, ``spiral_update``)
    against its plain version on the card: K=7 and K=9 in both families,
    SPIRAL with an inverted polynomial, K=5 and K=3 (lanes past S copy
    states) in both; batches 1, 33 and 130; 45, 301 and 64 steps (two of
    them no multiple of the 32-step stage); random u8 entry metrics (ka9q's
    adds wrap) and all-noise symbols, on which SPIRAL's renormalisation
    fires: the kernel with the threshold out of reach gives other metrics
    (it must, for every SPIRAL code).  One launch an update."""
    for code, spiral in U8_SMALL:
        name = "spiral_update" if spiral else "quantized_update"
        fired = []
        for B, T in U8_SMALL_SHAPES:
            m0 = torch.from_numpy(rng.integers(0, 256, (B, code.num_states), dtype=np.uint8)).cuda()
            sym = torch.from_numpy(rng.integers(0, 256, (B, T, 2), dtype=np.uint8)).cuda()
            n = _build.LAUNCHES[name]
            m_k = hold_u8(name, f"{code.name} B={B} T={T}", code, m0, sym, spiral, errs)
            if _build.LAUNCHES[name] != n + 1:
                raise SystemExit(f"FAIL {name}: {_build.LAUNCHES[name] - n} launches an update")
            if spiral:
                saved, quantized.SPIRAL_RENORM_THRESHOLD = quantized.SPIRAL_RENORM_THRESHOLD, 255
                try:
                    m_off = quantized._update(code, m0, sym, True)[0]
                finally:
                    quantized.SPIRAL_RENORM_THRESHOLD = saved
                fired.append(not torch.equal(m_off, m_k))
        if spiral:
            print(f"spiral_update {code.name}: the renormalisation fired in {sum(fired)} of "
                  f"{len(fired)} cases")
            if not any(fired):
                raise SystemExit(f"FAIL spiral_update {code.name}: the renormalisation never fired")
    print(f"[{tag}] the u8 replicas' kernel vs plain version: all bit-identical")


# The shard step's comparison set: (code, mesh axes) at batches 1, 3 and 8,
# SHARD_STEPS steps, with and without words.  K=9 on state=8 has 16
# predecessor pairs a shard (half a warp); K=15 is r=1/6.
_K17 = CodeSpec("k17r2", 17, 2, (0o247461, 0o323475))
SHARD_SMALL = ((VITERBI29, {"state": 2}), (VITERBI29, {"state": 4}), (VITERBI29, {"state": 8}),
               (VITERBI615, {"state": 4}), (_K17, {"state": 4}))
SHARD_STEPS = 6
ST_BYTES, ST_OVERLAP = 64, 96  # path 9's state x time frame: T = 535, padded to 536
# Path 9's noisy ICE frames (B=8), made by the comparisons, used by path 9 and the timing.
SHARD_ICE: dict[str, torch.Tensor] = {}
# The tracebacks of path 9's two ICE decodes ("sw", "st"): the arguments of
# ``_sharded_traceback`` and the plain version's time on them, from the comparisons.
WALK_ICE: dict[str, tuple] = {}


def near_limit_metrics(rng, shape) -> torch.Tensor:
    """int32 entry metrics on the card: uniform in [0, 5000), a quarter of
    them within 600 of the int32 limit, so that the adds wrap."""
    m = rng.integers(0, 5000, size=shape)
    top = rng.random(shape) < 0.25
    m[top] = (2**31 - 1) - rng.integers(0, 600, size=int(top.sum()))
    return torch.from_numpy(m.astype(np.int32)).cuda()


def hold_shard(label, mesh, code, numeric, m0, sym, record, errs):
    """The scan's route on the card (one ``sharded_acs_scan`` launch a step,
    the metrics interleaved, as in one process) and the same scan on
    half-major metrics (as across processes, ``_scan_on_card``), each
    against the plain version ``_sharded_acs_scan_ref`` on the same inputs:
    metrics and every word.  Returns the route's metrics."""
    _, s2_block, _ = statewise._shard_geometry(code, mesh, "state")
    args = (mesh, code, numeric, m0, sym, "state", statewise._parity_index(code, s2_block), record)
    n = _build.LAUNCHES["sharded_acs_scan"]
    m_k, d_k = statewise._sharded_acs_scan(*args)
    m_h, d_h = statewise._scan_on_card(*args[:6], record, True)
    launched = _build.LAUNCHES["sharded_acs_scan"] - n
    m_r, d_r = statewise._sharded_acs_scan_ref(*args)
    torch.cuda.synchronize()
    e = max(max_abs_err(m, m_r) for m in (m_k, m_h))
    if record:
        e = max(e, max_abs_err(d_k, d_r), max_abs_err(d_h, d_r))
    print(f"sharded_acs_scan {label}, both layouts: max_abs_err {e}")
    errs["sharded_acs_scan"] = max(errs["sharded_acs_scan"], check(f"sharded_acs_scan {label}", e))
    if launched != 2 * sym.shape[2]:
        raise SystemExit(f"FAIL sharded_acs_scan {label}: {launched} launches for "
                         f"{sym.shape[2]} steps in two layouts")
    if record:  # the words walked from a random end state a line and frame
        g = np.random.default_rng(code.K * m0.shape[1])
        end = torch.empty((mesh.n_local, m0.shape[1]), dtype=torch.int32)
        for ln in mesh.lines_in_process("state"):
            end[ln] = torch.from_numpy(g.integers(0, code.num_states, size=end.shape[1],
                                                  dtype=np.int32))
        hold_walk(label, mesh, code, d_k, end.cuda(), errs)
    return m_k


def hold_step_entry(label, mesh, code, numeric, m0, sym, errs):
    """The one-step entry point ``shard.sharded_acs_step`` (a plan of one
    step: the new metrics interleaved, ``[n, B, 2 chunk]``, the sources
    strided halves from ``Mesh.ppermute_sources``) against the plain scan's
    first step: metrics and words, one launch."""
    n_dev = mesh.shape["state"]
    n, B, n_local = m0.shape
    chunk = n_local // 2
    perm_lo, perm_hi = statewise.butterfly_perms(n_dev)
    lo0, lo1, hi0, hi1 = mesh.ppermute_sources(
        "state", (m0[..., :chunk], perm_lo[0]), (m0[..., chunk:], perm_lo[1]),
        (m0[..., :chunk], perm_hi[0]), (m0[..., chunk:], perm_hi[1]))
    lo = [a if a is not None else b for a, b in zip(lo0, lo1)]
    hi = [a if a is not None else b for a, b in zip(hi0, hi1)]
    out = torch.empty_like(m0)
    words = torch.empty((n, B, -(-n_local // 32)), dtype=torch.int32, device="cuda")
    before = _build.LAUNCHES["sharded_acs_scan"]
    shard.sharded_acs_step(code, lo, hi, [c * chunk for c in mesh.axis_coords("state")],
                           statewise._symbol_tables(code, numeric, sym).contiguous(), 0, out,
                           words)
    launched = _build.LAUNCHES["sharded_acs_scan"] - before
    _, s2_block, _ = statewise._shard_geometry(code, mesh, "state")
    m_r, d_r = statewise._sharded_acs_scan_ref(mesh, code, numeric, m0, sym[:, :, :1], "state",
                                               statewise._parity_index(code, s2_block), True)
    e = max(max_abs_err(out, m_r), max_abs_err(words, d_r[0]))
    print(f"sharded_acs_scan {label}, one step through sharded_acs_step: max_abs_err {e}")
    errs["sharded_acs_scan"] = max(errs["sharded_acs_scan"], check(f"sharded_acs_scan {label}", e))
    if launched != 1:
        raise SystemExit(f"FAIL sharded_acs_step {label}: {launched} launches for one step")


def bits_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two uint8 bit tensors."""
    return 0 if torch.equal(a, b) else int((a.int() - b.int()).abs().max())


def hold_walk(label, mesh, code, dec, end, errs) -> float:
    """The traceback's two card routes against its plain version
    ``_sharded_traceback_ref`` on the same words and end states: the walk
    (``_sharded_traceback``: one ``sharded_traceback`` launch) and the step
    route (``_walk_steps``, as where the lines span processes: one
    ``sharded_traceback_step`` launch and one ``psum`` a step).  Returns the
    plain version's time, ms."""
    base, _, n_local = statewise._shard_geometry(code, mesh, "state")
    args = (mesh, code, dec, end, base, n_local, "state")
    before = dict(_build.LAUNCHES)
    got = statewise._sharded_traceback(*args)
    walks = _build.LAUNCHES["sharded_traceback"] - before["sharded_traceback"]
    steps = statewise._walk_steps(mesh, code, dec, end, n_local, "state")
    step_launches = _build.LAUNCHES["sharded_traceback_step"] - before["sharded_traceback_step"]
    out = []
    plain_ms = once_ms(lambda: out.append(statewise._sharded_traceback_ref(*args)))
    torch.cuda.synchronize()
    for name, bits in (("sharded_traceback", got), ("sharded_traceback_step", steps)):
        e = bits_err(bits, out[0])
        print(f"{name} {label}: max_abs_err {e}")
        errs[name] = max(errs[name], check(f"{name} {label}", e))
    if (walks, step_launches) != (1, dec.shape[0]):
        raise SystemExit(f"FAIL sharded_traceback {label}: {walks} walk launches and "
                         f"{step_launches} step launches for {dec.shape[0]} steps")
    return plain_ms


def phase_kernels_shard(tag, rng, errs):
    """The state-sharded trellis step (``sharded_acs_scan``) against the plain
    scan on the card: ``SHARD_SMALL`` at batches 1, 3 and 8 over
    ``SHARD_STEPS`` steps, words on and off, from entry metrics near the
    int32 limit and random soft16 symbols, each shard its own; then at ICE
    on state=4, B=8, the first 3 steps from path 9's noisy symbols and bias
    metrics, and 2 steps of its state x time shape (one frame on (state=4,
    time=2), 8 shards) from near-limit metrics.  No whole ICE scan in the
    plain version (4.2 ms a step)."""
    for code, axes in SHARD_SMALL:
        mesh = parallel.Mesh(axes, "cuda")
        numeric = soft16_spec(code.R)
        for i, B in enumerate((1, 3, 8)):
            n_local = code.num_states // axes["state"]
            m0 = near_limit_metrics(rng, (mesh.n_local, B, n_local))
            sym = torch.from_numpy(rng.integers(numeric.soft_low, numeric.soft_high + 1, size=(
                mesh.n_local, B, SHARD_STEPS, code.R)).astype(np.int32)).cuda()
            for record in (True, False):
                hold_shard(f"{code.name} on {axes} B={B} {'words' if record else 'no words'}",
                           mesh, code, numeric, m0, sym, record, errs)
            hold_step_entry(f"{code.name} on {axes} B={B}", mesh, code, numeric, m0, sym, errs)
    ice = soft8_spec(2)
    SHARD_ICE["data"], SHARD_ICE["noisy"] = noisy_symbols(ice, B_ICE, rng, 3, VITERBI224,
                                                          ICE_BYTES)
    mesh = parallel.Mesh({"state": 4}, "cuda")
    base, _, n_local = statewise._shard_geometry(VITERBI224, mesh, "state")
    sym = mesh.shard(SHARD_ICE["noisy"], ())[:, :, :3].contiguous()
    hold_shard(f"ICE B={B_ICE} on state=4, path 9's first 3 steps", mesh, VITERBI224, ice,
               statewise._bias_metrics(VITERBI224, ice, mesh, base, B_ICE, n_local), sym, True,
               errs)
    mesh = parallel.Mesh({"state": 4, "time": 2}, "cuda")
    sym = torch.from_numpy(rng.integers(ice.soft_low, ice.soft_high + 1, size=(
        mesh.n_local, 1, 2, 2)).astype(np.int32)).cuda()
    hold_shard("ICE B=1 on (state=4, time=2), 2 steps", mesh, VITERBI224, ice,
               near_limit_metrics(rng, (mesh.n_local, 1, n_local)), sym, True, errs)
    # Path 9's two ICE decodes: their tracebacks' inputs as the decodes hand them over.
    _, st_noisy = noisy_symbols(ice, 1, rng, 3, VITERBI224, ST_BYTES)
    cases = (("sw", f"ICE B={B_ICE} on state=4, path 9's whole words", lambda: (
        parallel.state_sharded_decode_bits(VITERBI224, ice, SHARD_ICE["noisy"],
                                           parallel.Mesh({"state": 4}, "cuda")))),
             ("st", f"ICE {ST_BYTES}-byte frame on (state=4, time=2), path 9's whole words",
              lambda: parallel.state_time_decode(
                  VITERBI224, ice, st_noisy, ST_BYTES * 8, parallel.Mesh({"state": 4, "time": 2},
                                                                         "cuda"),
                  overlap=ST_OVERLAP)))
    for key, label, run in cases:
        with captured_tracebacks() as seen:
            run()
        args = seen[0]
        WALK_ICE[key] = (args, hold_walk(label, args[0], VITERBI224, args[2], args[3], errs))
    torch.cuda.empty_cache()
    print(f"[{tag}] the shard step and the walks vs their plain versions: all bit-identical")


@contextlib.contextmanager
def captured_tracebacks():
    """The arguments of every ``_sharded_traceback`` call inside the block
    (``parallel/statewise.py`` and ``parallel/state_time.py``, which imports
    it), each call made as it would be."""
    from ka9q_viterbi_comparison_tpu_torch.parallel import state_time

    seen, saved = [], [(mod, mod._sharded_traceback) for mod in (statewise, state_time)]
    for mod, fn in saved:
        def keep(*args, fn=fn):
            seen.append(args)
            return fn(*args)
        mod._sharded_traceback = keep
    try:
        yield seen
    finally:
        for mod, fn in saved:
            mod._sharded_traceback = fn


def phase_kernels_inplace_forms(tag, rng, errs):
    """The in-place ACS kernel's forms (a warp a frame up to K=9, a block a
    frame above; the complement and the generic
    penalty look-up) and both traceback forms (staged up to K=9, candidate
    fetches above), each against its plain version on random symbols and
    random entry metrics (so not in state order): K=9 soft16 at B=512, every
    kind of ``t0``, ``t_real`` odd / not a multiple of 32 / below 32, batches
    that do not fill a warp's or a block's frames, K=3..13, R=1..6, codes that
    do not tap both register ends, and two chained halves against the whole."""
    def note(name, e):
        errs[name] = max(errs[name], e)

    def rand_inputs(code, numeric, B, T):
        sym = torch.from_numpy(rng.integers(numeric.soft_low, numeric.soft_high + 1,
                                            size=(T, code.R, B)).astype(np.int32)).cuda()
        m = torch.from_numpy(rng.integers(0, 60, size=(code.num_states, B)).astype(np.int32)).cuda()
        end = torch.from_numpy(rng.integers(0, code.num_states, size=(1, B))
                               .astype(np.int32)).cuda()
        return sym, m, end

    def one(code, numeric, B, T, t_real, t0):
        sym, m, end = rand_inputs(code, numeric, B, T)
        label = f"{code.name} {numeric.name} B={B} T={T} t_real={t_real} t0={t0}"
        e, (_, d) = compare_update(f"acs_update_inplace {label}", inplace.acs_update_inplace,
                                   inplace.acs_update_inplace_ref,
                                   (code, numeric, m, sym, t_real, t0), t_real)
        note("acs_update_inplace", e)
        note("chainback_inplace", compare_walk(
            f"chainback_inplace {label}", inplace.chainback_inplace,
            inplace.chainback_inplace_ref, (code, d, end, t_real, t0), t_real))
        note("chainback_tb", compare_walk(
            f"chainback_tb {label}", kernels.chainback_tb, kernels.chainback_tb_ref,
            (code, d, end, t_real), t_real))

    def halves(code, numeric, B, T, t0):
        sym, m, end = rand_inputs(code, numeric, B, T)
        T1 = T // 2 - 1
        mw, dw = inplace.acs_update_inplace(code, numeric, m, sym, T, t0)
        m1, d1 = inplace.acs_update_inplace(code, numeric, m, sym[:T1].contiguous(), T1, t0)
        m2, d2 = inplace.acs_update_inplace(code, numeric, m1, sym[T1:].contiguous(), T - T1,
                                            t0 + T1)
        torch.cuda.synchronize()
        e = max(max_abs_err(m2, mw), max_abs_err(torch.cat([d1[:T1], d2[:T - T1]]), dw[:T]))
        print(f"acs_update_inplace {code.name} B={B} two halves (t0={t0}, {t0 + T1}) vs the whole "
              f"frame: max_abs_err {e}")
        note("acs_update_inplace", check(f"{code.name} chained halves", e))
        pad = torch.zeros((-T1 % 32 + 32, *d2.shape[1:]), dtype=torch.int32, device="cuda")
        whole = dispatch.unpack_bit_words(inplace.chainback_inplace(code, dw, end, T, t0), T)
        window = dispatch.unpack_bit_words(
            inplace.chainback_inplace(code, torch.cat([d2[:T - T1], pad]), end, T - T1, t0 + T1),
            T - T1)
        e = int((whole[:, T1:] != window).sum())
        print(f"chainback_inplace {code.name} B={B} window t0={t0 + T1} vs the whole walk: "
              f"{e} bits differ")
        note("chainback_inplace", check(f"{code.name} chained walk", e))

    k7 = CODE
    one(VITERBI29, soft16_spec(2), 512, 1030, 1030, 3)
    for t0 in (0, 1, 5, k7.K - 2, k7.K - 1):
        one(k7, soft8_spec(2), 513, 320, 299, t0)
    one(k7, soft8_spec(2), 33, 64, 31, 4)
    one(k7, soft8_spec(2), 9000, 96, 77, 2)     # several warps a scheduler
    one(VITERBI47, soft8_spec(4), 9200, 96, 96, 1)
    one(VITERBI49, soft8_spec(4), 130, 200, 199, 7)
    one(CodeSpec("k3r2", 3, 2, (0o7, 0o5)), soft8_spec(2), 33, 100, 99, 1)
    one(CodeSpec("k5r2", 5, 2, (0o23, 0o35)), soft8_spec(2), 9100, 70, 45, 3)
    one(CodeSpec("k6r2", 6, 2, (0o53, 0o75)), soft8_spec(2), 33, 100, 100, 4)
    one(CodeSpec("k8r3", 8, 3, (0o247, 0o371, 0o225)), soft8_spec(3), 130, 150, 149, 6)
    one(CodeSpec("k11r2", 11, 2, (0o3345, 0o2671)), soft8_spec(2), 33, 200, 199, 9)
    one(CodeSpec("k13r1", 13, 1, (0o16731,)), soft8_spec(1), 9, 150, 131, 12)
    one(CodeSpec("k12r6", 12, 6, (0o6731, 0o5247, 0o7153, 0o4657, 0o5735, 0o7461)),
        soft16_spec(6), 8, 100, 97, 5)
    # Polynomials that tap neither register end: the generic penalty look-up.
    one(CodeSpec("k7oneend", 7, 2, (0o155, 0o056)), soft8_spec(2), 130, 150, 149, 5)
    one(CodeSpec("k9oneend", 9, 3, (0o557, 0o256, 0o711)), soft8_spec(3), 33, 150, 150, 2)
    one(CodeSpec("k10oneend", 10, 2, (0o1167, 0o0546)), soft8_spec(2), 17, 150, 141, 8)
    halves(VITERBI29, soft8_spec(2), 130, 301, 3)
    halves(CodeSpec("k11r2", 11, 2, (0o3345, 0o2671)), soft8_spec(2), 9, 150, 7)
    # What the Python side says of the launch is what the launcher does.
    fns = _build.library()
    for code in (k7, VITERBI47, VITERBI29, VITERBI49, VITERBI615,
                 CodeSpec("k5r2", 5, 2, (0o23, 0o35)), CodeSpec("k10oneend", 10, 2, (0o1167, 0o0546))):
        got = fns["viterbi_acs_inplace_smem"](code.K, code.R, int(inplace.complement_form(code)))
        want = inplace.inplace_smem_bytes(code)
        if got != want:
            raise SystemExit(f"FAIL: {code.name}: the launcher takes {got} bytes of shared "
                             f"memory, ops/cuda/inplace.py says {want}")
    torch.cuda.empty_cache()
    print(f"[{tag}] in-place ACS forms and both traceback forms vs plain versions: all "
          f"bit-identical")


# The whole-frame ACS kernels' timing rows and their shapes: each also runs
# on batch-major views of its compared inputs (``phase_kernels_views``).
VIEW_ROWS = (("acs_update_tb", None, "K=7 B=64"), ("acs_update_inplace", None, "K=7 B=512"),
             ("acs_update_inplace", "k15", "Cassini B=256"), ("acs_update_tb2", None, "K=7 B=1024"),
             ("acs_update_tb2", "k9", "K=9 soft16 B=1024"))


def phase_kernels_views(tag, errs):
    """Rows 1, 3 and 5 (``acs_update_tb``, ``acs_update_inplace``,
    ``acs_update_tb2``) on batch-major views of the inputs they were
    compared on -- symbols ``[B, T, R]`` handed over as ``permute(1, 2, 0)``
    and metrics ``[B, S]`` as ``.T``, the decoder's layout -- against their
    contiguous launch on those inputs (the launch the plain version was held
    to): metrics and words must be identical.  Both launches timed by CUDA
    events, in turns."""
    fns = {"acs_update_tb": kernels.acs_update_tb, "acs_update_inplace": inplace.acs_update_inplace,
           "acs_update_tb2": kernels2.acs_update_tb2}
    for name, key, label in VIEW_ROWS:
        args = compared_args(name, key)
        code, numeric, m0, s, T = args[:5]
        s_bm, m_bm = s.permute(2, 0, 1).contiguous(), m0.T.contiguous()
        view_args = (code, numeric, m_bm.T, s_bm.permute(1, 2, 0), *args[4:])
        fn = fns[name]
        m_c, d_c = fn(*args)
        m_v, d_v = fn(*view_args)
        torch.cuda.synchronize()
        err = max(max_abs_err(m_v, m_c), max_abs_err(d_v[:T], d_c[:T]))
        errs[name] = max(errs[name], check(f"{name} {label} on batch-major views", err))
        del m_c, d_c, m_v, d_v
        iters = 3 if code.K > 9 else 10
        ms = [timed_ms(lambda: fn(*a), iters) for a in (args, view_args, view_args, args)]
        print(f"[{tag}] {name} {label} T={T} on batch-major views: max_abs_err {err} against the "
              f"contiguous launch; {(ms[1] + ms[2]) / 2:.4f} ms (views) against "
              f"{(ms[0] + ms[3]) / 2:.4f} ms ([Tp, R, B] and [S, B] contiguous), in turns "
              f"{', '.join(f'{x:.4f}' for x in ms)}")
        del s_bm, m_bm, view_args
    torch.cuda.empty_cache()


def phase_kernels_tb_forms(tag, rng, errs):
    """The state-order ACS through both entry points (the warp form up to
    K=9, the block forms at K=10), each case against its plain version and
    ``acs_update_tb2`` also against the ``acs_update_tb`` kernel, on random
    symbols and random entry metrics: K=2..10, R=1..6, codes with and without
    the complement form, ``t_real`` odd, below 32 and not a multiple of 32,
    batches of 1, 33 and 130 that do not fill a block's two warps."""
    cases = [  # code, numeric, B, T, t_real
        (CodeSpec("k2r2", 2, 2, (0o3, 0o1)), soft8_spec(2), 33, 40, 37),
        (CodeSpec("k3r2", 3, 2, (0o7, 0o5)), soft8_spec(2), 1, 100, 99),
        (CodeSpec("k4r1", 4, 1, (0o15,)), soft8_spec(1), 130, 64, 31),
        (CodeSpec("k5r2", 5, 2, (0o23, 0o35)), soft8_spec(2), 33, 100, 77),
        (CodeSpec("k6r3", 6, 3, (0o53, 0o75, 0o47)), soft8_spec(3), 130, 100, 100),
        (CODE, soft8_spec(2), 1, 300, 299),
        (VITERBI47, soft8_spec(4), 33, 300, 257),
        (CodeSpec("k7r6", 7, 6, (0o155, 0o117, 0o127, 0o171, 0o133, 0o165)), soft8_spec(6), 130,
         100, 95),
        (CodeSpec("k7oneend", 7, 2, (0o155, 0o056)), soft8_spec(2), 130, 150, 149),
        (CodeSpec("k8r5", 8, 5, (0o247, 0o371, 0o225, 0o353, 0o311)), soft8_spec(5), 33, 100, 63),
        (VITERBI29, soft16_spec(2), 130, 300, 300),
        (VITERBI49, soft8_spec(4), 1, 200, 199),
        (CodeSpec("k9oneend", 9, 3, (0o557, 0o256, 0o711)), soft8_spec(3), 33, 150, 150),
        (CodeSpec("k10r2", 10, 2, (0o1167, 0o1546)), soft8_spec(2), 33, 100, 99),
    ]
    for code, numeric, B, T, t_real in cases:
        sym = torch.from_numpy(rng.integers(numeric.soft_low, numeric.soft_high + 1,
                                            size=(T, code.R, B)).astype(np.int32)).cuda()
        m = torch.from_numpy(rng.integers(0, 60, size=(code.num_states, B)).astype(np.int32)).cuda()
        label = f"{code.name} {numeric.name} B={B} T={T} t_real={t_real}"
        e, (m_t, d_t) = compare_update(f"acs_update_tb {label}", kernels.acs_update_tb,
                                       kernels.acs_update_tb_ref, (code, numeric, m, sym, t_real),
                                       t_real)
        errs["acs_update_tb"] = max(errs["acs_update_tb"], e)
        if code.K < 3:
            continue
        e, (m_k, d_k) = compare_update(f"acs_update_tb2 {label}", kernels2.acs_update_tb2,
                                       kernels2.acs_update_tb2_ref,
                                       (code, numeric, m, sym, t_real), t_real)
        e = max(e, check(f"acs_update_tb2 {label} vs the acs_update_tb kernel",
                         max(max_abs_err(m_k, m_t), max_abs_err(d_k[:t_real], d_t[:t_real]))))
        errs["acs_update_tb2"] = max(errs["acs_update_tb2"], e)
    # What the Python side says of the launch is what the launcher does.
    fns = _build.library()
    for code, _, _, _, _ in cases:
        for depth, want in ((1, kernels.acs_smem_bytes(code)), (2, kernels2.tb2_smem_bytes(code))):
            got = fns["viterbi_acs_tb_smem"](code.K, code.R, depth)
            if got != want:
                raise SystemExit(f"FAIL: {code.name}: the launcher takes {got} bytes of shared "
                                 f"memory at depth {depth}, ops/cuda says {want}")
    torch.cuda.empty_cache()
    print(f"[{tag}] state-order ACS forms (both entry points) vs plain versions: all "
          f"bit-identical")


class inplace_off:
    """``KA9Q_TORCH_INPLACE=0`` inside the block, the earlier value after."""

    def __enter__(self):
        self.saved = os.environ.get("KA9Q_TORCH_INPLACE")
        os.environ["KA9Q_TORCH_INPLACE"] = "0"

    def __exit__(self, *exc):
        if self.saved is None:
            del os.environ["KA9Q_TORCH_INPLACE"]
        else:
            os.environ["KA9Q_TORCH_INPLACE"] = self.saved


def native_walk(code, words_native, nbits, endstate: int):
    """One ``chainback_tb`` walk over native-layout words from a host-side end
    state: bytes ``[B, nbits // 8]``."""
    dec, T, B = words_native
    end = torch.full((1, B), endstate & (code.num_states - 1), dtype=torch.int32, device="cuda")
    bits = dispatch.unpack_bit_words(kernels.chainback_tb(code, dec, end, T), T)
    return bits_to_bytes(bits[:, code.K - 1:code.K - 1 + nbits])


def phase_kernels_tb2(tag, rng, errs):
    """The depth-2 state-order kernel against its plain version and against
    the ``acs_update_tb`` kernel on the same inputs (metrics and words
    [:t_real] identical): the tb2 path's own shape, an odd ``t_real``, one
    that ends inside a 32-step stage of symbols, K=9 soft16, both R=4 codes,
    and a K=5 code at a small batch."""
    def one(code, numeric, B, n_bytes, noise, t_cuts=(0,), keep=None):
        _, sym = noisy_symbols(numeric, B, rng, noise, code, n_bytes)
        s = trb(sym)
        T = s.shape[0]
        m0 = metrics0(code, numeric, B) + torch.randint(0, 40, (code.num_states, B),
                                                        dtype=torch.int32, device="cuda")
        for cut in t_cuts:
            t = T - cut
            label = f"acs_update_tb2 {code.name} {numeric.name} B={B} T={T} t_real={t}"
            e, (m_k, d_k) = compare_update(label, kernels2.acs_update_tb2,
                                           kernels2.acs_update_tb2_ref,
                                           (code, numeric, m0, s, t), t, None if cut else keep)
            m_t, d_t = kernels.acs_update_tb(code, numeric, m0, s, t)
            torch.cuda.synchronize()
            e = max(e, check(label + " vs the acs_update_tb kernel",
                             max(max_abs_err(m_k, m_t), max_abs_err(d_k[:t], d_t[:t]))))
            errs["acs_update_tb2"] = max(errs["acs_update_tb2"], e)

    # T = 8198: 8197 is odd (one step A alone); 8185 ends 25 steps into a stage.
    one(CODE, soft8_spec(2), B_TB2, FRAME_BYTES, 4, (0, 1, 13), keep=("acs_update_tb2", None))
    one(VITERBI29, soft16_spec(2), B_TB2, 512, 160, keep=("acs_update_tb2", "k9"))
    one(VITERBI47, soft8_spec(4), B_TB2, 1024, 4)
    one(VITERBI49, soft8_spec(4), B_TB2, 512, 4, (0, 1))
    one(CodeSpec("k5r2", 5, 2, (0o23, 0o35)), soft8_spec(2), 33, 8, 3, (0, 1))
    torch.cuda.empty_cache()
    print(f"[{tag}] acs_update_tb2 vs its plain version and vs the acs_update_tb kernel: "
          f"all bit-identical")


def drive_tb2_path(tag, rng):
    """Path 5, the depth-2 route: K=7 soft8 1024-byte frames at B=1024 with
    the in-place route off for this path only.  First through the decoder
    (``drive_path``: one ``acs_update_tb2`` and one ``chainback_tb`` a decode,
    no other ACS kernel), then the same shapes through ``phase_fns`` (the four
    phases, and chains of three links against three separate calls)."""
    code, numeric, B, nbits = CODE, soft8_spec(2), B_TB2, FRAME_BYTES * 8
    with inplace_off():
        dec_launches = drive_path(tag, "K=7 depth-2", code, numeric, FRAME_BYTES, [(B, None)], rng,
                                  ("acs_update_tb2", "chainback_tb"))
        want = {"acs_update_tb2": 2, "chainback_tb": 2}  # a noiseless and a noisy decode
        if {k: v for k, v in dec_launches.items() if v} != want:
            raise SystemExit(f"FAIL: the depth-2 decoder path launched {dec_launches}, not {want}")

        data, clean = noisy_symbols(numeric, B, rng, 0)
        noisy_data, noisy = noisy_symbols(numeric, B, rng, 4)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        init_fn, update_fn, chainback_fn, prepare_fn, make_cb_chain, make_up_chain = \
            dispatch.phase_fns(code, numeric, nbits, B)
        m, words, off = update_fn(init_fn(B), prepare_fn(clean))
        decoded = chainback_fn(words)
        prepared = prepare_fn(noisy)
        mn, words_n, _ = update_fn(init_fn(B), prepared)
        dec_noisy = chainback_fn(words_n)
        # Chains of three links against three separate calls.
        m3, (d3, _, _) = make_up_chain(3)(init_fn(B), prepared)
        ms = init_fn(B)
        for _ in range(3):
            ms, ws, _ = update_fn(ms, prepared)
        out3 = make_cb_chain(3)(words_n)
        # ... and three separate walks whose end state crosses the host.
        outs = native_walk(code, words_n, nbits, 0)
        for _ in range(2):
            outs = native_walk(code, words_n, nbits, int(outs[0, -1]))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    print(f"[{tag}] K=7 depth-2 phase_fns path launches: {json.dumps(launches)}")
    others = [k for k, v in launches.items() if v and k not in ("acs_update_tb2", "chainback_tb")]
    if others or not launches["acs_update_tb2"] or not launches["chainback_tb"]:
        raise SystemExit(f"FAIL: the depth-2 phase_fns path launched {launches}")
    errors = count_bit_errors(decoded, data)
    pm_ok = bool((m[0] + off == 0).all())
    ref = ViterbiDecoder(code, numeric, B, "torch")
    ref.update(noisy)
    same = bool(torch.equal(dec_noisy, ref.chainback(nbits)))
    m_same = bool(torch.equal(mn.T, ref.metrics))
    del ref
    T = words_n[1]
    up_same = bool(torch.equal(m3, ms) and torch.equal(d3[:T], ws[0][:T]))
    cb_same = bool(torch.equal(out3, outs))
    print(f"[{tag}] decode K=7 depth-2 phase_fns B={B} {FRAME_BYTES}-byte frames: noiseless bit "
          f"errors {errors}, path metric 0 on all frames {pm_ok}, noisy equal to backend=torch "
          f"{same} (metrics {m_same}), noisy bit errors {count_bit_errors(dec_noisy, noisy_data)}; "
          f"update chain of 3 equal to three calls {up_same}, chainback chain of 3 equal to three "
          f"walks {cb_same}")
    if errors or not (pm_ok and same and m_same and up_same and cb_same):
        raise SystemExit("FAIL: end-to-end depth-2 phase_fns decode")
    torch.cuda.empty_cache()
    return {k: dec_launches[k] + launches[k] for k in launches}


def drive_runner(tag):
    """Path 6, the benchmark runner in-process on the card: the six codes at
    its default batches and the reference's frame sizes, every numeric spec
    (16 rows), ``backends=["cuda"]``, a short sampling time.  One call of
    ``run_matrix`` per code, with the launch counts zeroed before it and read
    after, shows which kernels served which code.  Every row must carry the
    reference schema's keys and a bit error rate of 0."""
    total = {name: 0 for name in _build.LAUNCHES}
    rows = []
    for code in STANDARD_CODES:
        out = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        saved, sys.stderr = sys.stderr, io.StringIO()  # the runner's progress lines
        try:
            runner.run_matrix(0.15, 3, out, codes=(code,), seed=SEED, backends=["cuda"])
        finally:
            sys.stderr = saved
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        for k, v in launches.items():
            total[k] += v
        print(f"[{tag}] runner {code.name} launches: {json.dumps(launches)}")
        want = (("acs_update_large4_fields8", "chainback_planes") if code.K > 15 else
                ("acs_update_inplace", "chainback_inplace"))
        if any(k not in launches for k in want) or (code.K <= 15 and len(launches) != 2):
            raise SystemExit(f"FAIL: runner {code.name} was served by {launches}, expected {want}")
        rows += json.loads(out.getvalue())
        torch.cuda.empty_cache()
    names = {(c.K, c.R): c.name for c in STANDARD_CODES}
    if len(rows) != 16:
        raise SystemExit(f"FAIL: the runner gave {len(rows)} rows, not 16")
    for r in rows:
        if set(r) != SCHEMA_KEYS:
            raise SystemExit(f"FAIL: runner row {r.get('name')} has keys {sorted(r)}")
        if r["bit_error_rate"] != 0 or r["total_samples"] < 3 or \
                r["total_samples"] != len(r["update_ns"]):
            raise SystemExit(f"FAIL: runner row K={r['K']} R={r['R']} {r['name']}: bit error rate "
                             f"{r['bit_error_rate']}, {r['total_samples']} samples")
        batch = runner.DEFAULT_BATCH[names[r["K"], r["R"]]]
        msym = r["total_output_symbols"] / np.mean(r["update_ns"]) * 1e3
        mbit = r["total_bits"] / np.mean(r["chainback_ns"]) * 1e3
        print(f"[{tag}] runner K={r['K']} R={r['R']} {r['name']} batch {batch}: update "
              f"{msym:.6g} Msym/s ({np.mean(r['update_ns']) / 1e6:.4f} ms), chainback "
              f"{mbit:.6g} Mbit/s ({np.mean(r['chainback_ns']) / 1e6:.4f} ms), init "
              f"{np.mean(r['init_ns']) / 1e3:.2f} us, {r['total_samples']} samples, bit error rate 0")
    gate_runner_rows(tag, rows)
    return total


def gate_runner_rows(tag, rows):
    """The gate's hard rules on path 6's rows (floor, BER, the roofline at
    every K, K=9 over K=7, every cell above its reference column): a
    violation fails the run.  Printed, not enforced: the std rule, since a
    0.15 s window of three or more samples is too short for it (the
    checked-in matrix must pass it)."""
    hard = check_results.check_rows(rows, hard_only=True)
    soft = [x for x in check_results.check_rows(rows) if x not in hard]
    for r in rows:
        rate = r["total_bits"] / np.mean(r["chainback_ns"]) * 1e9
        per_bit = check_results.walk_bytes_per_bit(r["name"], r["K"])
        print(f"[{tag}] runner roofline {r['name']} K={r['K']} R={r['R']}: chainback "
              f"{rate / 1e9:.6g} Gbit/s x {per_bit} B/bit = {rate * per_bit / 1e9:.6g} GB/s of "
              f"{check_results.HBM_BYTES_PER_S / 1e9:.0f}")
    for e in check_results.vs_baseline_rows(rows):
        print(f"[{tag}] runner {e['name']} K={e['K']} R={e['R']} vs the reference: " + ", ".join(
            f"{ph} {e[ph]['ratio']:.2f}x {e[ph]['column']}" for ph in ("update", "chainback")
            if ph in e))
    for x in soft:
        print(f"[{tag}] runner std rule (printed, not enforced on 0.15 s windows): {x}")
    if hard:
        raise SystemExit("FAIL: the runner's rows break the gate's hard rules:\n" + "\n".join(hard))
    print(f"[{tag}] runner rows: the gate's hard rules hold on all {len(rows)} rows, the "
          f"roofline at every K ({len(soft)} std notes)")


def drive_phase_fns(tag, rng):
    """The ICE frames through ``dispatch.phase_fns``: the launch counts are
    zeroed just before and read just after.  Whole frames take the f8 route
    (noiseless: 0 bit errors, path metric 0; noisy: bytes and every state's
    metric + offset equal to ``backend="torch"``); asked for 7 of the 8
    bytes, the same noisy frames take the f4 route."""
    code, numeric, B = VITERBI224, soft8_spec(2), B_ICE
    nbits = ICE_BYTES * 8
    data, clean = noisy_symbols(numeric, B, rng, 0, code, ICE_BYTES)
    noisy_data, noisy = noisy_symbols(numeric, B, rng, 3, code, ICE_BYTES)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    init_fn, update_fn, chainback_fn, prepare_fn = dispatch.phase_fns(code, numeric, nbits, B)[:4]
    outs = []
    for sym in (clean, noisy):
        m, table, off = update_fn(init_fn(B), prepare_fn(sym))
        if not (isinstance(table, dict) and set(table) == {"f8"}):
            raise SystemExit("FAIL: the ICE phase_fns update did not return an f8 table")
        outs.append((m, off, chainback_fn(table)))
        del table
    init7, update7, chainback7, prepare7 = dispatch.phase_fns(code, numeric, nbits - 8, B)[:4]
    m7, table7, off7 = update7(init7(B), prepare7(noisy))
    if set(table7) != {"f4"}:
        raise SystemExit("FAIL: the ICE phase_fns update for part of a frame did not return f4")
    out7 = chainback7(table7)
    del table7
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[{tag}] ICE phase_fns path launches: {json.dumps(launches)}")
    for name in ("acs_update_large4_fields8", "acs_update_large4_fields", "acs_update_large4",
                 "chainback_planes"):
        if launches[name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was not launched on the ICE phase_fns path")

    (m, off, decoded), (mn, offn, dec_noisy) = outs
    errors = count_bit_errors(decoded, data)
    pm_ok = bool((m[:, 0] + off == 0).all())
    ref = ViterbiDecoder(code, numeric, B, "torch")
    ref.update(noisy)
    ref_bytes = ref.chainback(nbits)
    same = bool(torch.equal(dec_noisy, ref_bytes))
    total = ref.metrics + ref.renorm_offset[:, None]
    del ref
    m_same = bool(torch.equal(mn + offn[:, None], total))
    same7 = bool(torch.equal(out7, ref_bytes[:, :ICE_BYTES - 1]))
    m7_same = bool(torch.equal(m7 + off7[:, None], total))
    print(f"[{tag}] decode ICE phase_fns B={B} {ICE_BYTES}-byte frames, f8 route: noiseless bit "
          f"errors {errors}, path metric 0 on all frames {pm_ok}, noisy equal to backend=torch "
          f"{same} (metrics + offset {m_same}), noisy bit errors "
          f"{count_bit_errors(dec_noisy, noisy_data)}; f4 route ({ICE_BYTES - 1} bytes asked): "
          f"equal to backend=torch {same7} (metrics + offset {m7_same})")
    if errors or not (pm_ok and same and m_same and same7 and m7_same) \
            or decoded.shape != (B, ICE_BYTES):
        raise SystemExit("FAIL: end-to-end ICE phase_fns decode")
    torch.cuda.empty_cache()
    return launches


def drive_path(tag, label, code, numeric, n_bytes, runs, rng, kernels_of_path):
    """One decode path through the user's entry point: the launch counts are
    zeroed just before it and read just after.  ``runs``: (batch, step
    blocks or None).  Noiseless frames must decode with 0 bit errors and
    path metric 0; noisy frames must equal ``backend="torch"`` in bytes and
    path metric."""
    nbits = n_bytes * 8
    frames = [(B, blocks, noisy_symbols(numeric, B, rng, 0, code, n_bytes),
               noisy_symbols(numeric, B, rng, 3, code, n_bytes)) for B, blocks in runs]
    torch.cuda.synchronize()
    results = []
    _build.reset_launch_counts()
    for B, blocks, (_, clean), (_, noisy) in frames:
        dec = ViterbiDecoder(code, numeric, batch=B, backend="cuda")
        out = []
        for sym in (clean, noisy):
            dec.reset()
            lo = 0
            for n in blocks or (sym.shape[1],):
                dec.update(sym[:, lo:lo + n])
                lo += n
            out += [dec.chainback(nbits), dec.path_metric(0)]
        results.append(out)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[{tag}] {label} path launches: {json.dumps(launches)}")
    for name in kernels_of_path:
        if launches[name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was not launched on the {label} path")

    for (B, blocks, (data, _), (noisy_data, noisy)), (decoded, pm, dec_noisy, pm_noisy) in zip(
            frames, results):
        errors = count_bit_errors(decoded, data)
        ref = ViterbiDecoder(code, numeric, B, "torch")
        ref.update(noisy)
        same = bool(torch.equal(dec_noisy, ref.chainback(nbits)))
        pm_same = bool(torch.equal(pm_noisy, ref.path_metric(0)))
        pm_ok = bool((pm == 0).all())
        del ref
        print(f"[{tag}] decode {label} B={B}{' in blocks ' + str(list(blocks)) if blocks else ''} "
              f"{n_bytes}-byte frames: noiseless bit errors {errors}, path metric 0 on all "
              f"frames {pm_ok}, noisy equal to backend=torch {same} (path metric {pm_same}), "
              f"noisy bit errors {count_bit_errors(dec_noisy, noisy_data)}")
        if errors or not pm_ok or not same or not pm_same or decoded.shape != (B, n_bytes):
            raise SystemExit(f"FAIL: end-to-end {label} decode at B={B}")
    torch.cuda.empty_cache()
    return launches


def trace_ops(fn, attempts: int = 3) -> tuple[int, dict[str, int], str, dict[str, int]]:
    """``trace_push``'s trace, and the device operations that are not the
    port's kernels, by name."""
    names: dict[str, int] = {}
    n_ops, port, attempt = trace_push(fn, attempts, names)
    return n_ops, port, attempt, names


def trace_push(fn, attempts: int = 3, others: dict | None = None) -> tuple[int, dict[str, int], str]:
    """Device operations in one call of ``fn`` (after one untraced call), by
    a profiler trace: ``(operations of any origin -- kernels, copies, fills --,
    {port kernel: launches}, which trace)``.  A trace is complete when it
    holds as many of the port's kernels as the wrappers' counters say the
    call launched; an incomplete one is taken again, up to ``attempts``
    times.  ``(-1, {}, ...)`` where the profiler recorded no device
    operation.  ``others``: filled with the other operations by name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, attempts + 1):
        before = sum(_build.LAUNCHES.values())
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        launched = sum(_build.LAUNCHES.values()) - before
        device_ops = [e for e in prof.events()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        if not device_ops and attempt < attempts:
            continue  # a trace with no device event at all is taken again
        port = {}
        if others is not None:
            others.clear()
        for e in device_ops:
            hit = re.search(r"(\w+)(<[^()]*>)?\(", e.name)
            if hit and hit.group(1) in PORT_KERNELS:
                port[hit.group(1)] = port.get(hit.group(1), 0) + 1
            elif others is not None:
                name = e.name[:60]
                others[name] = others.get(name, 0) + 1
        if not device_ops:
            return -1, {}, f"trace {attempt}"
        if sum(port.values()) >= launched:
            return len(device_ops), port, f"trace {attempt}, complete"
    return len(device_ops), port, f"{attempts} traces, each missing some of {launched} launches"


def drive_stream(tag, rng, code, B, n, pushes, kernels_of_path):
    """One stream of path 7 through ``StreamingDecoder(backend="cuda")``:
    noiseless random bits in ``pushes`` pushes of ``n`` steps and a flush must
    come out as the data; a decoder restored from the checkpoint taken after
    the second push must release the same bits as the uninterrupted stream;
    two pushes of noisy symbols must equal ``backend="torch"``'s.  The launch
    counts are zeroed before and read after.  Then the steady-state push rate
    (CUDA events over the pushes after the first two) beside the batch update
    rate of the same code and batch; the device operations a push are traced
    at the end of the run (``phase_launch_trace``)."""
    numeric = soft8_spec(code.R)
    L = pushes * n - (code.K - 1)  # data bits; the encoder's tail ends the stream
    bits = rng.integers(0, 2, size=(B, L), dtype=np.uint8)
    enc = encode_bits(code, torch.from_numpy(bits))
    clean = torch.where(enc.bool(), numeric.soft_high, numeric.soft_low).to(torch.int32).cuda()
    kept = COMPARED.get(("acs_update_inplace", None) if B >= 128 else ("acs_update_tb", None))
    if code is CODE and kept is not None and kept[0][3].shape[0] >= 4 * n \
            and kept[0][3].shape[2] == B:
        noisy = kept[0][3].permute(2, 0, 1)  # a compared shape's [T, R, B] symbols
        where = "the compared shape's symbols"
    else:
        noisy = noisy_symbols(numeric, B, rng, 3, code, (4 * n) // 8 + 1)[1]
        where = "new symbols"
    label = f"{code.name} B={B} {n}-step pushes"
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    dec = StreamingDecoder(code, numeric, B)
    out, state = [], None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    host = []  # the host's microseconds to issue each timed push
    for i in range(pushes):
        if i == 2:
            start.record()
            gc0 = gc.get_stats()[2]["collections"]
        t_host = time.perf_counter()
        out.append(dec.push(clean[:, i * n:(i + 1) * n]))
        host.append(1e6 * (time.perf_counter() - t_host))
        if i == 1:
            state = dec.checkpoint()
    host, gen2 = host[2:], gc.get_stats()[2]["collections"] - gc0
    host_us = sum(host) / len(host)
    end.record()
    out.append(dec.flush(0))
    resumed = StreamingDecoder(code, numeric, B)
    resumed.restore(state)
    again = [resumed.push(clean[:, i * n:(i + 1) * n]) for i in range(2, pushes)]
    again.append(resumed.flush(0))
    noisy_dec = StreamingDecoder(code, numeric, B)
    noisy_out = [noisy_dec.push(noisy[:, i * n:(i + 1) * n]) for i in range(2)]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[{tag}] stream {label} path launches: {json.dumps(launches)}")
    for name in kernels_of_path:
        if launches[name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was not launched on the stream {label}")

    steady_ms = start.elapsed_time(end)
    released = torch.cat(out, dim=1)
    errors = count_bit_errors(bits_to_bytes(released[:, :L - L % 8]), np.packbits(
        bits[:, :L - L % 8], axis=1))
    whole = released.shape[1] == L and bool((released.cpu().numpy() == bits).all())
    same_resumed = bool(torch.equal(torch.cat(again, dim=1), torch.cat(out[2:], dim=1)))
    ref = StreamingDecoder(code, numeric, B, backend="torch")
    ref_out = [ref.push(noisy[:, i * n:(i + 1) * n]) for i in range(2)]
    same_noisy = all(torch.equal(a, b) for a, b in zip(noisy_out, ref_out)) \
        and noisy_out[1].shape[1] == n
    del ref, ref_out
    rate = (pushes - 2) * n * B * code.R / (steady_ms * 1e-3) / 1e6
    upd_ms, _ = decoder_phases(tag, code, numeric, B, CAS_BYTES if code.K > 9 else FRAME_BYTES,
                               rng, f"{code.name} (batch, beside the stream)")
    T_batch = code.transmit_bits(CAS_BYTES if code.K > 9 else FRAME_BYTES)
    batch_rate = B * T_batch * code.R / (upd_ms * 1e-3) / 1e6
    print(f"[{tag}] stream {label} ({'position' if dec._rotated else 'state'}-packed history): "
          f"{pushes} noiseless pushes and a flush released {released.shape[1]} bits, bit errors "
          f"{errors}, all equal to the data {whole}; restored after push 2: equal {same_resumed}; "
          f"2 noisy pushes ({where}) equal to backend=torch {same_noisy}; steady state "
          f"{(pushes - 2)} pushes in {steady_ms:.4f} ms = {steady_ms / (pushes - 2):.4f} ms a push "
          f"= {rate:.1f} Msym/s (host {host_us:.1f} us to issue a push: median "
          f"{float(np.median(host)):.1f}, most {max(host):.1f}; {gen2} full garbage collections "
          f"among them); batch update "
          f"{upd_ms:.4f} ms = {batch_rate:.1f} Msym/s")
    if errors or not (whole and same_resumed and same_noisy):
        raise SystemExit(f"FAIL: stream {label}")
    del dec, resumed, noisy_dec, clean, noisy
    torch.cuda.empty_cache()
    return launches


# Path 8's replica symbols, kept for the replicas' timing rows: code name ->
# [B, 2T] uint8 on the card.
U8_SYMBOLS: dict[str, torch.Tensor] = {}


def drive_awgn(tag, rng, errs):
    """Path 8: a BER point at VITERBI27 soft16 on the kernels through the curve
    CLI's own function, ``harness.ber_curve.main`` (coded BER must lie below
    the uncoded); the ka9q and SPIRAL u8 replicas on AWGN
    offset-binary symbols at K=7 and K=9 on the card (the u8 kernel and
    ``chainback_tb``), their first 8 frames byte-identical to the same
    functions on the CPU; the launch counts zeroed before and read after.
    Then, outside the counted run, the replicas' kernel on the same symbols
    against its plain version on the first 64 frames (one plain run a code
    and family; ``errs`` takes their largest error), and the
    runner's ``cpu_native`` rows for viterbi27 and viterbi615 (the host
    decoder: no kernel)."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints its doc
        record = ber_curve.main(["--code", CODE.name, "--spec", "soft16", "--ebn0", str(BER_EBN0),
                                 "--frame-bytes", str(BER_BYTES), "--batch", str(B_BER),
                                 "--min-errors", "100", "--max-bits", "10000000",
                                 "--seed", str(SEED)])
    ber_s = time.perf_counter() - t0
    (point,) = record["points"]
    lo, hi = point["ber_ci"]
    print(f"[{tag}] BER {CODE.name} soft16 B={B_BER} {BER_BYTES}-byte frames at {BER_EBN0} dB "
          f"(harness.ber_curve): {point['errors']} errors in {point['bits']} bits = "
          f"{point['ber']:.6g} (95 % Wilson interval [{lo:.6g}, {hi:.6g}]), FER "
          f"{point['fer']:.4g}, uncoded {point['uncoded_ber']:.6g}; {ber_s:.3f} s")
    if not (0 < point["ber"] < point["uncoded_ber"]):
        raise SystemExit(f"FAIL: coded BER {point['ber']} against uncoded "
                         f"{point['uncoded_ber']}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    same = True
    for code in (VITERBI27, VITERBI29):
        data = rng.integers(0, 256, size=(B_BER, FRAME_BYTES), dtype=np.uint8)
        sym = channel.awgn_symbols(code, ka9q_offset_binary_spec(), data, BER_EBN0, gen)
        sym = sym.to(torch.uint8)
        U8_SYMBOLS[code.name] = sym
        for fam, fn in (("ka9q", quantized.decode_symbols_ka9q),
                        ("spiral", quantized.decode_symbols_spiral)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(code, sym, FRAME_BYTES * 8)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            cpu = fn(code, sym[:8].cpu(), FRAME_BYTES * 8, device="cpu")
            cpu_ms = (time.perf_counter() - t0) * 1e3
            ok = bool(torch.equal(out[:8].cpu(), cpu))
            same = same and ok
            print(f"[{tag}] {fam} replica {code.name} B={B_BER} {FRAME_BYTES}-byte frames at "
                  f"{BER_EBN0} dB: {ms:.1f} ms on the card "
                  f"({B_BER * code.transmit_bits(FRAME_BYTES) * 2 / ms / 1e3:.2f} Msym/s), bit "
                  f"errors {count_bit_errors(out, data)}; first 8 frames equal to the CPU's {ok} "
                  f"({cpu_ms:.1f} ms there)")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[{tag}] AWGN and replica path launches: {json.dumps(launches)}")
    for name in ("acs_update_inplace", "chainback_inplace", "chainback_tb", "quantized_update",
                 "spiral_update"):
        if launches[name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was not launched on the AWGN and replica path")
    if not same:
        raise SystemExit("FAIL: a u8 replica on the card differs from the CPU's")
    for code in (VITERBI27, VITERBI29):
        sym = U8_SYMBOLS[code.name].reshape(B_BER, -1, 2)
        m0 = quantized.init_metrics_u8(code, B_BER)
        for spiral in (False, True):
            name = "spiral_update" if spiral else "quantized_update"
            m_k, w_k = quantized._update(code, m0, sym, spiral)
            t0 = time.perf_counter()
            m_r, w_r = quantized._u8_update(code, m0[:U8_HELD], sym[:U8_HELD], spiral)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            e = max(u8_err(m_k[:U8_HELD], m_r), max_abs_err(w_k[..., :U8_HELD].contiguous(), w_r))
            label = f"{code.name} B={B_BER} AWGN {BER_EBN0} dB, first {U8_HELD} frames"
            print(f"{name} {label}: max_abs_err {e} (plain version {plain_s:.2f} s)")
            errs[name] = max(errs[name], check(f"{name} {label}", e))
    # Cassini on the host takes over a second a 256-byte frame, so its rows
    # decode one 64-byte frame.
    for code, batch, n_bytes, samples in ((VITERBI27, None, None, 3), (VITERBI615, 1, 64, 1)):
        out = io.StringIO()
        saved, sys.stderr = sys.stderr, io.StringIO()
        try:
            t0 = time.perf_counter()
            runner.run_matrix(0.05, samples, out, codes=(code,), batch_override=batch,
                              frame_bytes_override=n_bytes, seed=SEED, backends=["native"])
            secs = time.perf_counter() - t0
        finally:
            sys.stderr = saved
        rows = json.loads(out.getvalue())
        for r in rows:
            if set(r) != SCHEMA_KEYS or r["bit_error_rate"] != 0 or \
                    not r["name"].startswith("cpu_native"):
                raise SystemExit(f"FAIL: runner native row {r.get('name')} of {code.name}")
            frame = n_bytes or BENCH_FRAME_BYTES[code.name]
            print(f"[{tag}] runner {code.name} {r['name']} {r['total_input_bytes'] // frame} "
                  f"{frame}-byte frames: update "
                  f"{r['total_output_symbols'] / np.mean(r['update_ns']) * 1e3:.6g} Msym/s "
                  f"({np.mean(r['update_ns']) / 1e6:.4f} ms), chainback "
                  f"{r['total_bits'] / np.mean(r['chainback_ns']) * 1e3:.6g} Mbit/s, "
                  f"{r['total_samples']} samples, bit error rate 0")
        print(f"[{tag}] runner {code.name} native rows: {len(rows)} in {secs:.2f} s")
    torch.cuda.empty_cache()
    return launches


def parallel_case(tag, label, fn, kernels_of_case, model_check):
    """One sharded decode of path 9: the launch counts zeroed just before,
    its collectives counted (``harness.comms.collective_trace``) and timed
    with CUDA events, the counts read just after and held against the
    analytic model by ``model_check(report)``.  Returns (output, launches)."""
    out = []
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    report = comms.collective_trace(lambda: out.append(fn()))
    end.record()
    end.synchronize()
    launches = dict(_build.LAUNCHES)
    counted = {c.prim: 0 for c in report.collectives}
    for c in report.collectives:
        counted[c.prim] += c.count
    ok, said = model_check(report)
    print(f"[{tag}] parallel {label}: {start.elapsed_time(end):.4f} ms on one card (the shard "
          f"plumbing's cost, not scaling: every shard runs on this card); collectives "
          f"{json.dumps(counted)}, {report.total_wire_bytes()} wire bytes; {said}: {ok}; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if not ok:
        raise SystemExit(f"FAIL: parallel {label}: the counted collectives differ from the model")
    for name in kernels_of_case:
        if launches[name] == 0:
            raise SystemExit(f"FAIL: kernel {name} was not launched on the parallel {label} path")
    return out[0], launches


def drive_parallel(tag, rng):
    """Path 9: the multi-device paths on in-process meshes on this one card
    (``parallel.Mesh``: the shards are the leading dimension of each
    tensor, their collectives index and reduction ops).  Frame DP (K=7,
    1024-byte frames, B=512 and B=64 on frame=4: 128 frames a shard on the
    in-place pair, 16 on the state-order pair), time blocks (K=7, 1024-byte
    frames padded to 8200 steps, B=64 on (frame=2, time=4) and on time=8,
    overlap 56: the shards fold into one in-place call), the state-sharded
    ICE decode (8-byte frames, B=8 on state=4) and the composed state x time
    ICE decode (one 64-byte frame, T = 535 padded to 536, on (state=4,
    time=2), overlap 96).  Noiseless bytes must equal the data and the
    unsharded decode; noisy frame-DP and state-sharded bytes the unsharded
    decode; noisy time-block bits the CPU's run of the same sharded function
    on 8 of the frames."""
    soft8 = soft8_spec(2)
    nbits = FRAME_BYTES * 8
    T = CODE.transmit_bits(FRAME_BYTES)
    total = {k: 0 for k in _build.LAUNCHES}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    def zero_collectives(rep):
        return rep.collectives == [], (f"no collective (frame_model: "
                                       f"{comms.frame_model(4, 1)['total_wire_bytes']} wire bytes)")

    for B, key, pair in ((B_INPLACE, "acs_update_inplace", ("acs_update_inplace", "chainback_inplace")),
                         (B_TB, "acs_update_tb", ("acs_update_tb", "chainback_tb"))):
        data, clean = noisy_symbols(soft8, B, rng, 0, CODE, FRAME_BYTES)
        kept = COMPARED.get((key, None))
        if kept is not None and tuple(kept[0][3].shape) == (T, 2, B):
            noisy, where = kept[0][3].permute(2, 0, 1), "the compared shape's symbols"
        else:
            noisy, where = noisy_symbols(soft8, B, rng, 3, CODE, FRAME_BYTES)[1], "new symbols"
        mesh = parallel.Mesh({"frame": 4}, "cuda")
        got, launches = parallel_case(
            tag, f"frame DP K=7 B={B} on frame=4 ({B // 4} a shard)",
            lambda: parallel.frame_sharded_decode(CODE, soft8, clean.reshape(B, -1), nbits, mesh),
            pair, zero_collectives)
        add(launches)
        got_noisy, launches = parallel_case(
            tag, f"frame DP K=7 B={B} noisy ({where})",
            lambda: parallel.frame_sharded_decode(CODE, soft8, noisy.reshape(B, -1), nbits, mesh),
            pair, zero_collectives)
        add(launches)
        want = unsharded_decode(CODE, soft8, noisy, nbits)
        errors, same = count_bit_errors(got, data), bool(torch.equal(got_noisy, want))
        print(f"[{tag}] parallel frame DP B={B}: bit errors {errors}, noisy equal to the "
              f"unsharded decode {same}")
        if errors or not same:
            raise SystemExit(f"FAIL: parallel frame DP at B={B}")

    # Time blocks: erasure symbols pad 8198 steps to 8200.
    B, OL = B_TB, 56
    pad = (-T) % 8
    data, clean = noisy_symbols(soft8, B, rng, 0, CODE, FRAME_BYTES)
    _, noisy = noisy_symbols(soft8, B, rng, 3, CODE, FRAME_BYTES)
    clean, noisy = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (clean, noisy))
    for axes in ({"frame": 2, "time": 4}, {"time": 8}):
        mesh = parallel.Mesh(axes, "cuda")
        b = B // axes.get("frame", 1)
        Tp = T + pad

        def tb_check(rep, b=b, n_time=axes["time"]):
            model = comms.timeblock_model(CODE, n_time, b, Tp, overlap=OL)
            perms = [c for c in rep.collectives if c.prim == "ppermute"]
            ok = (rep.total_count() == rep.total_count("ppermute") == model["halo_ppermutes"]
                  and all(c.payload_bytes == model["halo_payload_bytes"]
                          and c.pairs == n_time - 1 for c in perms))
            return ok, (f"timeblock_model: {model['halo_ppermutes']} halo ppermutes of "
                        f"{model['halo_payload_bytes']} bytes, predicted efficiency "
                        f"{model['predicted_efficiency']:.4f} at the H100's figures")

        route = ("acs_update_inplace", "chainback_inplace")
        got, launches = parallel_case(
            tag, f"time blocks K=7 B={B} on {axes}, overlap {OL}",
            lambda: parallel.time_block_decode(CODE, soft8, clean, nbits, mesh, overlap=OL),
            route, tb_check)
        add(launches)
        got_noisy, launches = parallel_case(
            tag, f"time blocks K=7 B={B} noisy on {axes}",
            lambda: parallel.time_block_decode_bits(CODE, soft8, noisy, mesh, overlap=OL),
            route, tb_check)
        add(launches)
        cpu = parallel.time_block_decode_bits(CODE, soft8, noisy[:8].cpu(),
                                              parallel.Mesh(axes, "cpu"), overlap=OL)
        errors = count_bit_errors(got, data)
        same_unsharded = bool(torch.equal(got, unsharded_decode(CODE, soft8, clean[:, :T], nbits)))
        same_cpu = bool(torch.equal(got_noisy[:8].cpu(), cpu))
        print(f"[{tag}] parallel time blocks on {axes}: bit errors {errors}, equal to the "
              f"unsharded decode {same_unsharded}; noisy bits of 8 frames equal to the CPU's "
              f"{same_cpu}")
        if errors or not (same_unsharded and same_cpu):
            raise SystemExit(f"FAIL: parallel time blocks on {axes}")

    # State sharding at ICE: 8-byte frames, B=8 over four shards.
    ice = soft8_spec(2)
    T_ice = VITERBI224.transmit_bits(ICE_BYTES)
    data, clean = noisy_symbols(ice, B_ICE, rng, 0, VITERBI224, ICE_BYTES)
    noisy = SHARD_ICE.get("noisy")
    if noisy is None:
        noisy = noisy_symbols(ice, B_ICE, rng, 3, VITERBI224, ICE_BYTES)[1]
    mesh = parallel.Mesh({"state": 4}, "cuda")

    def sw_check(rep):
        model = comms.statewise_model(VITERBI224, 4, B_ICE, T_ice)
        perms = [c for c in rep.collectives if c.prim == "ppermute"]
        ok = (rep.total_count("ppermute") == model["update_ppermutes"]
              and sum(c.wire_bytes for c in perms) == model["step_wire_bytes"]
              and rep.total_count("psum") == model["traceback_psums"]
              and rep.total_count() == 5 * T_ice)
        return ok, (f"statewise_model: {model['update_ppermutes']} ppermutes, "
                    f"{model['step_wire_bytes']} wire bytes a step, {model['traceback_psums']} "
                    f"psums, predicted step efficiency "
                    f"{model['predicted_step_efficiency']:.4f} at the H100's figures")

    outs = []
    for sym, kind in ((clean, "noiseless"), (noisy, "noisy")):
        got, launches = parallel_case(
            tag, f"state-sharded ICE B={B_ICE} {kind} on state=4",
            lambda sym=sym: parallel.state_sharded_decode(VITERBI224, ice, sym, ICE_BYTES * 8, mesh),
            ("sharded_acs_scan", "sharded_traceback"), sw_check)
        add(launches)
        outs.append(got)
        if launches["sharded_acs_scan"] != T_ice or launches["sharded_traceback"] != 1:
            raise SystemExit(f"FAIL: the state-sharded ICE decode launched the shard step "
                             f"{launches['sharded_acs_scan']} times, not once a step ({T_ice}), "
                             f"and the walk {launches['sharded_traceback']} times, not once")
    want = unsharded_decode(VITERBI224, ice, noisy, ICE_BYTES * 8)
    errors, same = count_bit_errors(outs[0], data), bool(torch.equal(outs[1], want))
    print(f"[{tag}] parallel state-sharded ICE: bit errors {errors}, noisy equal to the unsharded "
          f"decode {same}")
    if errors or not same:
        raise SystemExit("FAIL: parallel state-sharded ICE")

    # More frames than a launch takes: K=9, 65537 noisy 2-byte frames (T = 24) on state=4.
    B_big, big_bytes = shard.MAX_B + 2, 2
    T_big = VITERBI29.transmit_bits(big_bytes)
    _, big = noisy_symbols(soft8, B_big, rng, 3, VITERBI29, big_bytes)

    def big_check(rep):
        model = comms.statewise_model(VITERBI29, 4, B_big, T_big)
        ok = (rep.total_count("ppermute") == model["update_ppermutes"]
              and rep.total_count("psum") == model["traceback_psums"])
        return ok, f"statewise_model: {model['update_ppermutes']} ppermutes"

    got, launches = parallel_case(
        tag, f"state-sharded K=9 B={B_big} 2-byte frames on state=4",
        lambda: parallel.state_sharded_decode(VITERBI29, soft8, big, big_bytes * 8,
                                              parallel.Mesh({"state": 4}, "cuda")),
        ("sharded_acs_scan", "sharded_traceback"), big_check)
    add(launches)
    runs = -(-B_big // shard.MAX_B)
    same = bool(torch.equal(got, unsharded_decode(VITERBI29, soft8, big, big_bytes * 8)))
    print(f"[{tag}] parallel state-sharded K=9 B={B_big}: the launcher reported "
          f"{launches['sharded_acs_scan']} launches for {T_big} steps ({runs} a step expected), "
          f"equal to the unsharded decode {same}")
    if not same or launches["sharded_acs_scan"] != runs * T_big:
        raise SystemExit(f"FAIL: the state-sharded decode at B={B_big}")
    del big, got

    # State x time at ICE: one 64-byte frame (T = 535, padded to 536).
    st_bytes, OL = ST_BYTES, ST_OVERLAP
    T_st = VITERBI224.transmit_bits(st_bytes)
    data, clean = noisy_symbols(ice, 1, rng, 0, VITERBI224, st_bytes)
    mesh = parallel.Mesh({"state": 4, "time": 2}, "cuda")

    def st_check(rep):
        model = comms.state_time_model(VITERBI224, 4, 2, 1, T_st + 1, overlap=OL)
        sperms = [c for c in rep.collectives if c.prim == "ppermute" and c.axes == ("state",)]
        ok = (sum(c.count for c in sperms) == model["update_ppermutes_per_device_stream"]
              and sum(c.wire_bytes for c in sperms) == model["step_wire_bytes"]
              and rep.total_count("psum") == model["traceback_psums"])
        return ok, (f"state_time_model: {model['update_ppermutes_per_device_stream']} state "
                    f"ppermutes, {model['traceback_psums']} psums, predicted efficiency "
                    f"{model['predicted_efficiency']:.4f} at the H100's figures")

    got, launches = parallel_case(
        tag, f"state x time ICE {st_bytes}-byte frame on (state=4, time=2), overlap {OL}",
        lambda: parallel.state_time_decode(VITERBI224, ice, clean, st_bytes * 8, mesh, overlap=OL),
        ("sharded_acs_scan", "sharded_traceback"), st_check)
    add(launches)
    steps = OL + (T_st + 1) // 2 + OL  # the warm-up, then the block and its halo
    if launches["sharded_acs_scan"] != steps or launches["sharded_traceback"] != 1:
        raise SystemExit(f"FAIL: the state x time ICE decode launched the shard step "
                         f"{launches['sharded_acs_scan']} times, not {steps}, and the walk "
                         f"{launches['sharded_traceback']} times, not once for both blocks")
    errors = count_bit_errors(got, data)
    same = bool(torch.equal(got, unsharded_decode(VITERBI224, ice, clean, st_bytes * 8)))
    print(f"[{tag}] parallel state x time ICE: bit errors {errors}, equal to the unsharded "
          f"decode {same}")
    if errors or not same:
        raise SystemExit("FAIL: parallel state x time ICE")
    torch.cuda.empty_cache()
    return total


def unsharded_decode(code, numeric, sym, nbits):
    """The unsharded decode of the same frames on the kernels."""
    return decode_symbols(code, numeric, sym.reshape(sym.shape[0], -1), nbits, backend="cuda")


def phase_decode(tag, rng, errs):
    """The nine paths; returns the launches of each kernel summed over the
    paths (``errs`` takes path 8's comparisons of the u8 kernel)."""
    forms0 = dict(_build.FORM_LAUNCHES)
    paths = [
        drive_path(tag, "K=7", CODE, soft8_spec(2), FRAME_BYTES, [(B_INPLACE, None), (B_TB, None)],
                   rng, ("acs_update_tb", "chainback_tb", "acs_update_inplace",
                         "chainback_inplace")),
        drive_path(tag, "Cassini", VITERBI615, soft8_spec(6), CAS_BYTES,
                   [(B_CAS_INPLACE, None), (B_CAS_LARGE, None),
                    (B_CAS_LARGE, (VITERBI615.transmit_bits(CAS_BYTES) // 2,) * 2)],
                   rng, ("acs_update_inplace", "chainback_inplace", "acs_update_large2",
                         "chainback_tb")),
    ]
    # Blocks of 41 and 46 steps: their 1- and 2-step remainders take the
    # streaming step and pair kernels, which a whole ICE frame does not reach.
    paths.append(drive_path(tag, "ICE", VITERBI224, soft8_spec(2), ICE_BYTES,
                            [(B_ICE, None), (B_ICE, (41, 46))], rng,
                            ("acs_update_large4", "acs_update_large2", "acs_update_large",
                             "chainback_tb")))
    paths.append(drive_phase_fns(tag, rng))
    paths.append(drive_tb2_path(tag, rng))
    paths.append(drive_runner(tag))
    for code, B, n, pushes, kernels_of_path in STREAMS:
        paths.append(drive_stream(tag, rng, code, B, n, pushes, kernels_of_path))
    paths.append(drive_awgn(tag, rng, errs))
    paths.append(drive_parallel(tag, rng))
    launches = {name: sum(p[name] for p in paths) for name in _build.LAUNCHES}
    forms = {k: v - forms0.get(k, 0) for k, v in _build.FORM_LAUNCHES.items() if v > forms0.get(k, 0)}
    print(f"[{tag}] the tracebacks' launches by output form over the nine paths (timing inside "
          f"paths 7 and 9 included): {json.dumps(forms)}")
    # Every kernel of the kernels line; the walk's step kernel runs only where
    # a state line spans processes, which no path of one card does.
    zero = [name for name, n in launches.items() if n == 0 and name in REPLACES]
    if zero:
        raise SystemExit(f"FAIL: kernels {zero} were not launched on any path")
    return launches


def phase_canary(tag, rng):
    """The in-place envelope's canary at B=512 (``hw_check.envelope_row``):
    Cassini noiseless frames through ``ViterbiDecoder(backend="cuda")`` on the
    in-place pair, held to the data."""
    row = hw_check.envelope_row(rng, 512)
    print(f"[{tag}] canary K=15 soft8 {row['frame_bytes']}-byte frames B={row['batch']}: "
          f"in-place route {row['routed_inplace']}, bit errors {row['bit_errors']}, shared memory "
          f"{row['smem_bytes']} of {row['smem_optin_bytes']} B a block, launches "
          f"{json.dumps(row['launches'])}, {row['seconds'] * 1e3:.2f} ms a decode")
    if (row["bit_errors"] or not row["routed_inplace"]
            or not row["launches"].get("acs_update_inplace")
            or not row["launches"].get("chainback_inplace")):
        raise SystemExit("FAIL: the in-place canary at K=15 B=512")
    torch.cuda.empty_cache()


def compared_args(name, key=None):
    """The inputs on which ``name`` was held against its plain version at the
    shape of its timing row ``key``."""
    return COMPARED[(name, key)][0]


def kernel_row(tag, rows, name, fn, ref, args, shape, bnd, iters, key=None, kwargs=None,
               steps=None, timer=timed_ms):
    """Time the kernel on ``args`` (with ``timer``).  Where these are the
    inputs of a comparison (``compared_args``), the plain version's time is
    that run's; else the plain version runs here, once."""
    kwargs = kwargs or {}
    ms = timer(lambda: fn(*args, **kwargs), iters)
    kept = COMPARED.pop((name, key), None)
    if kept is not None and kept[0] is args:
        plain_ms = kept[1]
    else:
        plain_ms = once_ms(lambda: ref(*args, **kwargs))
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
    if key:
        rows.setdefault(name, {})[key] = row
    else:
        rows[name] = row
    print(f"[{tag}] {name} {shape}: kernel {ms:.4f} ms"
          + (f" = {1e6 * ms / steps:.1f} ns a step" if steps else "")
          + f", plain {plain_ms:.2f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
          f"{100 * bnd[0] / ms:.1f}% of bound")
    return ms


def decoder_phases(tag, code, numeric, B, n_bytes, rng, label, unit=("Msym/s", 1e6)):
    """Update and chainback phase times of one decoder (layout changes
    included): update as the median of five host-recorded CUDA event pairs
    after a warm-up, chainback as a CUDA-event mean."""
    T = code.transmit_bits(n_bytes)
    nbits = n_bytes * 8
    _, sym = noisy_symbols(numeric, B, rng, 3, code, n_bytes)
    dec = ViterbiDecoder(code, numeric, B, "cuda")
    upd = []
    for _ in range(6):
        dec.reset()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dec.update(sym)
        end.record()
        end.synchronize()
        upd.append(start.elapsed_time(end))
    upd_ms = float(np.median(upd[1:]))
    cb_ms = timed_ms(lambda: dec.chainback(nbits), 5)
    rate = B * T * code.R / (upd_ms * 1e-3) / unit[1]
    mbit = B * nbits / (cb_ms * 1e-3) / 1e6
    print(f"[{tag}] decoder {label} B={B} update phase {upd_ms:.4f} ms = {rate:.1f} {unit[0]}; "
          f"chainback phase {cb_ms:.4f} ms = {mbit:.4g} Mbit/s")
    return upd_ms, cb_ms


def phase_timing(tag, rng):
    numeric = soft8_spec(2)
    T = CODE.transmit_bits(FRAME_BYTES)
    rows = {}

    shape = f"K=7 B={B_TB} T={T}"
    tb_args = compared_args("acs_update_tb")
    kernel_row(tag, rows, "acs_update_tb", kernels.acs_update_tb, kernels.acs_update_tb_ref,
               tb_args, shape, acs_bound_ms(B_TB, T), 20, steps=T)
    # One frame (the reference's own unit), and K=9 soft16 512-byte frames at
    # B=64: frames of compared inputs, held against the compared calls' frames.
    _, k9_numeric, k9_m0, k9_s, T9 = compared_args("acs_update_tb2", "k9")
    for code, num, m0, s, t, label in (
            (CODE, numeric, tb_args[2], tb_args[3], T, f"K=7 B=1 T={T}"),
            (VITERBI29, k9_numeric, k9_m0, k9_s, T9, f"K=9 soft16 B={B_TB} T={T9}")):
        B = 1 if code is CODE else B_TB
        m_b, s_b = m0[:, :B].contiguous(), s[..., :B].contiguous()
        whole = (kernels.acs_update_tb if code is CODE else kernels2.acs_update_tb2)(
            code, num, m0, s, t)
        got = kernels.acs_update_tb(code, num, m_b, s_b, t)
        torch.cuda.synchronize()
        check(f"acs_update_tb {label} vs frames of the compared call",
              max(max_abs_err(got[0], whole[0][:, :B]), max_abs_err(got[1][:t], whole[1][:t, :, :B])))
        del whole, got
        ms = timed_ms(lambda: kernels.acs_update_tb(code, num, m_b, s_b, t), 20)
        bnd = acs_bound_ms(B, t, code)
        print(f"[{tag}] acs_update_tb {label}: kernel {ms:.4f} ms = {1e6 * ms / t:.1f} ns a step, "
              f"bound {bnd[0]:.6f} ms ({bnd[1]}), {100 * bnd[0] / ms:.2f}% of bound (frames "
              f"identical to the compared call's)")
    walk_args = {"chainback_tb": compared_args("chainback_tb")}
    kernel_row(tag, rows, "chainback_tb", kernels.chainback_tb, kernels.chainback_tb_ref,
               walk_args["chainback_tb"], shape, chainback_bound_ms(B_TB, T, False), 20, steps=T)
    form_rows(tag, rows, "chainback_tb", walk_args["chainback_tb"], shape)
    shape = f"K=7 B={B_INPLACE} T={T}"
    kernel_row(tag, rows, "acs_update_inplace", inplace.acs_update_inplace,
               inplace.acs_update_inplace_ref, compared_args("acs_update_inplace"), shape,
               acs_bound_ms(B_INPLACE, T), 20, steps=T)
    walk_args["chainback_inplace"] = compared_args("chainback_inplace")
    kernel_row(tag, rows, "chainback_inplace", inplace.chainback_inplace,
               inplace.chainback_inplace_ref, walk_args["chainback_inplace"], shape,
               chainback_bound_ms(B_INPLACE, T, True), 20, steps=T)
    form_rows(tag, rows, "chainback_inplace", walk_args["chainback_inplace"], shape)
    # The in-place pair at K=9 (VITERBI29 soft16, 512-byte frames), B=512.
    k9, s16, B = VITERBI29, soft16_spec(2), B_INPLACE
    _, sym = noisy_symbols(s16, B, rng, 160, k9, 512)
    s, m0 = trb(sym), metrics0(k9, s16, B)
    T9 = s.shape[0]
    end = torch.zeros((1, B), dtype=torch.int32, device="cuda")
    shape = f"K=9 soft16 B={B} T={T9}"
    _, (_, d) = compare_update(f"acs_update_inplace {shape}", inplace.acs_update_inplace,
                               inplace.acs_update_inplace_ref, (k9, s16, m0, s, T9, 0), T9,
                               ("acs_update_inplace", "k9"))
    compare_walk(f"chainback_inplace {shape}", inplace.chainback_inplace,
                 inplace.chainback_inplace_ref, (k9, d, end, T9, 0), T9, ("chainback_inplace", "k9"))
    hold_forms(shape, "chainback_inplace", k9, d, end, T9, FORM_ERRS, 0)
    del d
    kernel_row(tag, rows, "acs_update_inplace", inplace.acs_update_inplace,
               inplace.acs_update_inplace_ref, compared_args("acs_update_inplace", "k9"), shape,
               acs_bound_ms(B, T9, k9), 20, key="k9", steps=T9)
    kernel_row(tag, rows, "chainback_inplace", inplace.chainback_inplace,
               inplace.chainback_inplace_ref, compared_args("chainback_inplace", "k9"), shape,
               chainback_bound_ms(B, T9, True), 20, key="k9", steps=T9)
    for B in (B_INPLACE, B_TB):
        decoder_phases(tag, CODE, numeric, B, FRAME_BYTES, rng,
                       f"K=7 ({'in-place' if dispatch.use_inplace(CODE, B, 'cuda') else 'state-order'})")
    return rows


def phase_timing_large(tag, rng, rows):
    """The large-K kernels at the Cassini path's shapes (the pair kernel on
    a whole B=64 frame; ``acs_update_large`` on chip on a 1031-step block and
    on one step, and streaming on its K=10 R=7 comparison), the K=7 kernels'
    K=15 shapes, and the Cassini decoder's phases."""
    cas, soft8 = VITERBI615, soft8_spec(6)
    T = cas.transmit_bits(CAS_BYTES)
    B = B_CAS_LARGE
    args = compared_args("acs_update_large2")
    _, _, m0, sym = args
    ms = kernel_row(tag, rows, "acs_update_large2", large_k2.acs_update_large2,
                    large_k2.acs_update_large2_ref, args,
                    f"cassini B={B} T={T}", acs_bound_ms(B, T, cas), 10)
    print(f"[{tag}] acs_update_large2 cassini B={B}: {1e3 * ms:.1f} us a call = "
          f"{1e3 * ms / (T // 2):.3f} us a pair (launches: phase_launch_trace)")
    half = T // 2
    ms = kernel_row(tag, rows, "acs_update_large", large_k.acs_update_large,
                    large_k.acs_update_large_ref, compared_args("acs_update_large"),
                    f"cassini B={B} T={half} (on chip)", acs_bound_ms(B, half, cas), 10)
    print(f"[{tag}] acs_update_large cassini B={B}: {1e3 * ms / half:.3f} us a step")
    tail = sym[:, T - 1:].contiguous()
    kernel_row(tag, rows, "acs_update_large", large_k.acs_update_large,
               large_k.acs_update_large_ref, (cas, soft8, m0, tail),
               f"cassini tail B={B} T=1 (on chip)", acs_bound_ms(B, 1, cas), 50, key="tail")
    args = compared_args("acs_update_large", "stream")
    kernel_row(tag, rows, "acs_update_large", large_k.acs_update_large,
               large_k.acs_update_large_ref, args, "k10r7 B=3 T=21 (streaming)",
               acs_bound_ms(3, 21, args[0]), 20, key="stream")

    kernel_row(tag, rows, "chainback_tb", kernels.chainback_tb, kernels.chainback_tb_ref,
               compared_args("chainback_tb", "k15"), f"cassini B={B} T={T}",
               chainback_bound_ms(B, T, False), 10, key="k15", steps=T)
    Bi = B_CAS_INPLACE
    args = compared_args("acs_update_inplace", "k15")
    sym = args[3].permute(2, 0, 1).contiguous()  # [T, R, B] -> [B, T, R]
    kernel_row(tag, rows, "acs_update_inplace", inplace.acs_update_inplace,
               inplace.acs_update_inplace_ref, args,
               f"cassini B={Bi} T={T}", acs_bound_ms(Bi, T, cas), 3, key="k15", steps=T)
    kernel_row(tag, rows, "chainback_inplace", inplace.chainback_inplace,
               inplace.chainback_inplace_ref, compared_args("chainback_inplace", "k15"),
               f"cassini B={Bi} T={T}", chainback_bound_ms(Bi, T, True), 10, key="k15", steps=T)
    del args
    # The pair kernel at the in-place route's batch, for the routing choice
    # (dispatch routes B >= 128 to the in-place pair, as the JAX package does).
    mb = metrics0(cas, soft8, Bi, state_major=False)
    ms = timed_ms(lambda: large_k2.acs_update_large2(cas, soft8, mb, sym), 3)
    print(f"[{tag}] acs_update_large2 cassini B={Bi} T={T} (not on the path): kernel {ms:.4f} ms "
          f"= {Bi * T * cas.R / ms / 1e3:.1f} Msym/s, bound {acs_bound_ms(Bi, T, cas)[0]:.4f} ms")
    del mb
    torch.cuda.empty_cache()
    decoder_phases(tag, cas, soft8, Bi, CAS_BYTES, rng, "cassini (in-place)")
    decoder_phases(tag, cas, soft8, B, CAS_BYTES, rng, "cassini (large-K pair)")


def phase_timing_quad(tag, rng, rows):
    """The three forms of the depth-4 kernel at the ICE paths' shapes (B=8,
    T=87), the pair kernel on the same steps beside them, and the phases of
    the ICE decoder and of ``phase_fns``.  Returns, for each form, the
    inputs and time of its quads alone (the call without its remainder or
    lead steps), for ``phase_launch_trace``."""
    ice, s8, B = VITERBI224, soft8_spec(2), B_ICE
    _, _, m0, sym = compared_args("acs_update_large4")
    T = sym.shape[1]
    shape = f"ice B={B} T={T}"
    quads = {}
    for name, lead, bnd in (
            ("acs_update_large4", None, acs_bound_ms(B, T, ice)),
            ("acs_update_large4_fields", ICE_LEAD4, fields_bound_ms(B, T, ICE_LEAD4, ice)),
            ("acs_update_large4_fields8", ICE_LEAD8, fields_bound_ms(B, T, ICE_LEAD8, ice))):
        args = compared_args(name)
        label = shape if lead is None else f"{shape} lead={lead}"
        ms = kernel_row(tag, rows, name, getattr(large_k4, name), getattr(large_k4, name + "_ref"),
                        args, label, bnd, 5)
        torch.cuda.empty_cache()
        # The octet and quad launches alone: the same call without its remainder or lead steps.
        nq = (T - (lead or 0)) // 4
        body = sym[:, (lead or 0):(lead or 0) + 4 * nq].contiguous()
        extra = () if lead is None else (0,)
        quads_ms = timed_ms(lambda: getattr(large_k4, name)(ice, s8, m0, body, *extra), 5)
        quads[name] = (args, body, extra, nq, quads_ms, ms)
    # The streaming pair kernel on the same steps (not on a path), on its comparison's inputs.
    ms = kernel_row(tag, rows, "acs_update_large2", large_k2.acs_update_large2,
                    large_k2.acs_update_large2_ref, compared_args("acs_update_large2", "ice"),
                    f"{shape} (streaming, not on a path)", acs_bound_ms(B, T, ice), 5, key="ice")
    print(f"[{tag}] acs_update_large2 {shape}: {1e3 * ms / (T // 2):.2f} us a pair; metric-traffic "
          f"floor {T // 2 + T % 2} passes {(T // 2 + T % 2) * metric_pass_ms(B, ice):.4f} ms")
    # acs_update_large on octets, and its one-step tail at path 3's shape.
    for key, label, steps in (("ice", shape, T), ("ice_tail", f"ice B={B} T=1", 1)):
        ms = kernel_row(tag, rows, "acs_update_large", large_k.acs_update_large,
                        large_k.acs_update_large_ref, compared_args("acs_update_large", key),
                        f"{label} (octets)", acs_bound_ms(B, steps, ice), 5 if steps > 1 else 20,
                        key=key)
        passes = -(-steps // 8)
        print(f"[{tag}] acs_update_large {label}: metric-traffic floor {passes} passes at 8 steps "
              f"a pass {passes * metric_pass_ms(B, ice):.4f} ms")
    del m0
    torch.cuda.empty_cache()
    decoder_phases(tag, ice, s8, B, ICE_BYTES, rng, "ICE (depth-4 words, chainback_tb)",
                   ("ksym/s", 1e3))
    torch.cuda.empty_cache()

    nbits = ICE_BYTES * 8
    init_fn, update_fn, chainback_fn, prepare_fn = dispatch.phase_fns(ice, s8, nbits, B)[:4]
    prepared = prepare_fn(sym)
    upd = []
    for _ in range(6):
        m = init_fn(B)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, table, _ = update_fn(m, prepared)
        end.record()
        end.synchronize()
        upd.append(start.elapsed_time(end))
    upd_ms = float(np.median(upd[1:]))
    cb_ms = timed_ms(lambda: chainback_fn(table), 5)
    print(f"[{tag}] phase_fns ICE B={B} (f8 route) update phase {upd_ms:.4f} ms = "
          f"{B * T * ice.R / upd_ms:.1f} ksym/s; chainback phase {cb_ms:.4f} ms = "
          f"{B * nbits / (cb_ms * 1e-3) / 1e6:.4g} Mbit/s")
    del table
    torch.cuda.empty_cache()
    return quads


def walk_bound_ms(B, fetches, nbits) -> tuple[float, str]:
    """Least time of the table walk by bytes and operations: one word a
    window and frame (what the data needs), the end state, the kept bytes;
    per window some 8 operations (index, fetch, extract, state update), per
    kept bit 4 (select, shift, or, store)."""
    return bound(4 * B * (fetches + 1) + B * nbits // 8, B * (8 * fetches + 4 * nbits))


def phase_timing_walk(tag, rows):
    """The two K > 15 walks (the table walk, and ``chainback_tb`` over the
    ICE words) at the ICE paths' shape (B=8, T=87) on their comparisons'
    inputs, beside the bound by bytes and operations (the kernels line's
    ``bound_ms``) and the latency bound (its ``latency_bound_ms``): dependent
    fetches a frame times the card's dependent-load latency
    (``probe_walk.load_latency_ns``: one thread chasing a random cycle
    through 256 MiB).  A walk launch is shorter than the Python that issues
    it, so the row's time is a replay of 50 calls captured as a CUDA graph
    (``probe_walk.graph_ms``); the time of the same calls issued from Python
    is printed beside it."""
    lat = probe_walk.load_latency_ns()
    T = VITERBI224.transmit_bits(ICE_BYTES)
    print(f"[{tag}] dependent-load latency over 256 MiB: {lat:.2f} ns")
    for key, width in ((None, 8), ("f4", 4)):
        fetches = probe_walk.plan_fetches(T, ICE_ANCHOR, width)
        args = compared_args("chainback_planes", key)
        ms = kernel_row(tag, rows, "chainback_planes", walk.chainback_planes,
                        walk.chainback_planes_ref, args,
                        f"ice f{width} B={B_ICE} T={T} anchor {ICE_ANCHOR}",
                        walk_bound_ms(B_ICE, fetches, ICE_BYTES * 8), 50, key=key,
                        timer=probe_walk.graph_ms)
        host = timed_ms(lambda: walk.chainback_planes(*args), 50)
        lat_ms = fetches * lat * 1e-6
        row = rows["chainback_planes"]
        (row[key] if key else row)["latency_bound_ms"] = lat_ms
        print(f"[{tag}] chainback_planes ice f{width}: latency bound {fetches} fetches x "
              f"{lat:.2f} ns = {lat_ms:.5f} ms ({100 * lat_ms / ms:.1f}% of the kernel's time); "
              f"issued from Python {host:.4f} ms a call")
    rounds = probe_walk.walk_rounds(T)
    args = compared_args("chainback_tb", "ice")
    ms = kernel_row(tag, rows, "chainback_tb", kernels.chainback_tb, kernels.chainback_tb_ref,
                    args, f"ice words B={B_ICE} T={T}", chainback_bound_ms(B_ICE, T, False), 50,
                    key="ice", steps=T, timer=probe_walk.graph_ms)
    host = timed_ms(lambda: kernels.chainback_tb(*args), 50)
    lat_ms = rounds * lat * 1e-6
    rows["chainback_tb"]["ice"]["latency_bound_ms"] = lat_ms
    print(f"[{tag}] chainback_tb ice words: latency bound {rounds} rounds of 5 steps x {lat:.2f} "
          f"ns = {lat_ms:.5f} ms ({100 * lat_ms / ms:.1f}% of the kernel's time); one fetch a "
          f"step would be {T * lat * 1e-6:.5f} ms; issued from Python {host:.4f} ms a call")
    torch.cuda.empty_cache()
    return lat


def u8_bound_ms(B, T, Tp, code, spiral) -> tuple[float, str]:
    """Least time of one u8 replica update: bytes = 2 symbol bytes a frame
    and step, the S metric bytes in and out, the words (4 W bytes a frame and
    row, all Tp rows written); operations per state and step = two adds, a
    compare, a select, the branch value's pick and the packing = 6, plus
    SPIRAL's one clamp (a second gives the same decision and metric)."""
    S, W = code.num_states, code.decision_words
    return bound(B * (2 * T + 2 * S + 4 * W * Tp), B * T * S * (7 if spiral else 6))


def phase_timing_u8(tag, rows):
    """The u8 replicas' kernel on path 8's AWGN symbols (B=512, 1024-byte
    frames) at K=7 and K=9, each family: the update alone by CUDA events
    (its plain version once, at the same shape), ns a step, the launches of
    one update and of one decode (``_build.LAUNCHES``), the bound, and the
    decode's rate (the kernel, ``chainback_tb``, unpack and pack) by CUDA
    events beside the reference decoders' own columns
    (``BASELINE_MSYM``)."""
    for code in (VITERBI27, VITERBI29):
        sym = U8_SYMBOLS.pop(code.name)
        sym3 = sym.reshape(B_BER, -1, 2)
        T = sym3.shape[1]
        Tp = inplace.pad_time_inplace(code, T)
        m0 = quantized.init_metrics_u8(code, B_BER)
        shape = f"{code.name} B={B_BER} T={T}"
        for fam, spiral, update, decode in (
                ("ka9q", False, quantized.quantized_update, quantized.decode_symbols_ka9q),
                ("spiral", True, quantized.spiral_update, quantized.decode_symbols_spiral)):
            name = update.__name__
            ms = kernel_row(tag, rows, name, update,
                            lambda c, m, s, spiral=spiral: quantized._u8_update(c, m, s, spiral),
                            (code, m0, sym3), shape, u8_bound_ms(B_BER, T, Tp, code, spiral), 20,
                            key=None if code is VITERBI27 else "k9", steps=T)
            torch.cuda.synchronize()
            before = dict(_build.LAUNCHES)
            update(code, m0, sym3)
            per_update = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
            before = dict(_build.LAUNCHES)
            decode(code, sym, FRAME_BYTES * 8)
            per_decode = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
            dms = timed_ms(lambda: decode(code, sym, FRAME_BYTES * 8), 10)
            rate = B_BER * T * code.R / dms / 1e3
            ref = BASELINE_MSYM[code.name][fam]
            print(f"[{tag}] {fam} replica {shape}: update {ms:.4f} ms = {1e6 * ms / T:.1f} ns a "
                  f"step, launches {json.dumps(per_update)}; decode {dms:.4f} ms = {rate:.1f} "
                  f"Msym/s, launches {json.dumps(per_decode)}; the reference's {fam} column "
                  f"{ref} Msym/s (BASELINE.md), {rate / ref:.1f}x")
            if per_update != {name: 1}:
                raise SystemExit(f"FAIL {name}: an update launched {per_update}")
    torch.cuda.empty_cache()


def shard_step_bound_ms(code, B) -> tuple[float, str]:
    """Least time of one shard step over all shards of a frame batch: bytes =
    every old metric read once, every new metric written once, a decision
    bit a state, the step's table rows (2^R ints a shard and frame, n = 4);
    operations = 6 a state (two adds, a compare, a select, a parity, the
    packing)."""
    S = code.num_states
    return bound(4 * B * S + 4 * B * S + B * S // 8 + 4 * 4 * B * (1 << code.R), 6 * B * S)


def sharded_walk_bound_ms(n, lines, B, T) -> tuple[float, str]:
    """Least time of the walk by bytes and operations: one word a step, line
    and frame (what the data needs), the end states, the [n, B, T] bytes
    out; some 8 operations a step, line and frame (shard split, address,
    fetch, extract, state update), and a store a step, shard and frame."""
    return bound(4 * lines * B * T + 4 * n * B + n * B * T, 8 * lines * B * T + n * B * T)


def phase_timing_walk_shard(tag, rows, lat):
    """The walk alone on the words and end states of path 9's two ICE
    tracebacks (``WALK_ICE``, from the comparisons), a replay of 50 launches
    captured as a CUDA graph (``probe_walk.graph_ms``), beside its bound and
    its latency bound (rounds of five steps x the dependent-load latency);
    the plain version's time from the comparison.  Then the step kernel alone
    (one launch, graph-replayed) and the step route from Python on the same
    words."""
    for key, label in (("sw", f"ICE B={B_ICE} on state=4"),
                       ("st", f"ICE {ST_BYTES}-byte frame on (state=4, time=2)")):
        (mesh, code, dec, end, base, n_local, axis), plain_ms = WALK_ICE.pop(key)
        lines = mesh.lines_in_process(axis)
        end = end.to(torch.int32).contiguous()
        T, n, B, _ = dec.shape
        ms = probe_walk.graph_ms(lambda: shard.sharded_walk(code, dec, end, lines, n_local), 50)
        bnd = sharded_walk_bound_ms(n, len(lines), B, T)
        rounds = probe_walk.walk_rounds(T)
        lat_ms = rounds * lat * 1e-6
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
               "latency_bound_ms": lat_ms}
        if key == "sw":  # the kernels line's row; state x time's under its key
            rows["sharded_traceback"] = row
        else:
            rows["sharded_traceback"]["state_time"] = row
        state, bit = end.clone(), torch.empty_like(end)
        bits = torch.empty((n, B, T), dtype=torch.uint8, device="cuda")
        coords = mesh.axis_coords(axis)
        step_ms = probe_walk.graph_ms(lambda: shard.sharded_walk_step(
            code, dec, T - 1, state, None, coords, n_local, bits, bit), 50)
        steps_ms = timed_ms(lambda: statewise._walk_steps(mesh, code, dec, end, n_local, axis), 3)
        print(f"[{tag}] sharded_traceback {label}, T={T}, {len(lines)} line(s) of {n // len(lines)} "
              f"shards, B={B}: walk {ms:.5f} ms (one launch), plain {plain_ms:.4f} ms, bound "
              f"{bnd[0]:.7f} ms ({bnd[1]}); latency bound {rounds} rounds of 5 steps x {lat:.2f} "
              f"ns = {lat_ms:.5f} ms ({100 * lat_ms / ms:.1f}% of the walk's time); the step "
              f"kernel alone {step_ms:.5f} ms a launch, the step route from Python "
              f"{steps_ms:.4f} ms ({T} launches and in-process psums)")
        del dec, end, state, bits
    torch.cuda.empty_cache()


def phase_timing_shard(tag, rows, lat):
    """The shard step alone at ICE B=8 on state=4, one card (every shard's
    launch on path 9's noisy symbols, its sources in place, the scan's own
    plan, ``statewise._plan_scan``, in its one-process layout and in the
    half-major one of a scan across processes), by CUDA events; the plain step
    (``_sharded_acs_scan_ref`` over one step) beside it; the walk alone
    (``phase_timing_walk_shard``); then path 9's two ICE decodes, each split
    into its scans and its traceback, with the host's microseconds a step
    beside the device's, the launches of one, and one traced run's device
    idle share (``harness.profiling.device_trace``)."""
    ice = soft8_spec(2)
    mesh = parallel.Mesh({"state": 4}, "cuda")
    base, s2_block, n_local = statewise._shard_geometry(VITERBI224, mesh, "state")
    sym = mesh.shard(SHARD_ICE["noisy"], ())  # [4, 8, 87, 2]
    m = statewise._bias_metrics(VITERBI224, ice, mesh, base, B_ICE, n_local)
    step_ms = {}
    for half_major in (False, True):
        plan = statewise._plan_scan(mesh, VITERBI224, ice, m, sym, "state", True, half_major)[0]
        step_ms[half_major] = timed_ms(lambda: plan.step(0, 0), 50)
        del plan
    ms = step_ms[False]
    pidx = statewise._parity_index(VITERBI224, s2_block)
    plain_ms = timed_ms(lambda: statewise._sharded_acs_scan_ref(
        mesh, VITERBI224, ice, m, sym[:, :, :1], "state", pidx, True), 3)
    bnd = shard_step_bound_ms(VITERBI224, B_ICE)
    rows["sharded_acs_scan"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                                "bound_by": bnd[1]}
    print(f"[{tag}] sharded_acs_scan ICE B={B_ICE} on state=4 (one card), one step: kernel "
          f"{ms:.4f} ms interleaved (one process's layout), {step_ms[True]:.4f} ms half-major "
          f"(across processes), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
          f"{100 * bnd[0] / ms:.1f}% of bound")
    phase_timing_walk_shard(tag, rows, lat)
    _, clean = noisy_symbols(ice, 1, np.random.default_rng(SEED), 0, VITERBI224, ST_BYTES)
    cases = (
        ("sw", f"state-sharded ICE B={B_ICE} on state=4", lambda: parallel.state_sharded_decode(
            VITERBI224, ice, SHARD_ICE["noisy"], ICE_BYTES * 8, mesh)),
        ("st", f"state x time ICE {ST_BYTES}-byte frame on (state=4, time=2)",
         lambda st=parallel.Mesh({"state": 4, "time": 2}, "cuda"): parallel.state_time_decode(
             VITERBI224, ice, clean, ST_BYTES * 8, st, overlap=ST_OVERLAP)))
    for key, label, fn in cases:
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        fn()  # warm
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
        steps = launched["sharded_acs_scan"]
        print(f"[{tag}] {label}: launches a decode {json.dumps(launched)}")
        for _ in range(2):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with profiling.sharded_phase_spans() as spans:
                start.record()
                fn()
                end.record()
            end.synchronize()
            split = {k: sum(a.elapsed_time(b) for a, b in spans[k]) for k in ("scan", "traceback")}
            host_ms = {k: 1e3 * sum(v) for k, v in spans["host_s"].items()}
            total = start.elapsed_time(end)
            print(f"[{tag}] {label}: decode {total:.4f} ms = scan {split['scan']:.4f} ms "
                  f"({len(spans['scan'])} scans) + traceback {split['traceback']:.4f} ms "
                  f"({100 * split['traceback'] / total:.1f}%) + the rest; the scans' issue on the "
                  f"host clock {host_ms['scan']:.4f} ms = {1e3 * host_ms['scan'] / steps:.2f} us "
                  f"a step against {1e3 * split['scan'] / steps:.2f} us a step of device span "
                  f"({steps} steps); the traceback's issue {host_ms['traceback']:.4f} ms")
        torch.cuda.synchronize()
        trace_dir = os.path.join("chiprun_out", f"chip_smoke_trace_{key}")
        with profiling.device_trace(trace_dir):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span_ms = 1e3 * (time.perf_counter() - t0)
        busy = profiling.device_busy_ms(trace_dir)
        print(f"[{tag}] {label}: one traced decode, span {span_ms:.4f} ms, device time "
              f"{busy:.4f} ms, idle share {100 * (1 - busy / span_ms):.1f}%")
    torch.cuda.empty_cache()


# The kernels of the large-K sources; each launch reads (frame_min_kernel) or
# reads and writes every frame's metrics once: a pass through device memory.
PASS_KERNELS = ("acs_pairs_chip_kernel", "acs_large_pair_kernel", "acs_large_step_kernel",
                "acs_large_octet_kernel", "acs_large_quad_kernel", "frame_min_kernel",
                "frame_sub_kernel")


# The state-order ACS kernels.
TB_KERNELS = ("acs_tb_warp_kernel", "acs_tb_block_kernel", "acs_tb2_block_kernel")
# Every kernel of the port's sources.
PORT_KERNELS = PASS_KERNELS + TB_KERNELS + ("acs_inplace_warp_kernel", "acs_inplace_block_kernel",
                                            "chainback_kernel", "plane_walk_kernel",
                                            "u8_warp_kernel", "sharded_acs_step_kernel",
                                            "sharded_walk_kernel", "sharded_walk_step_kernel")


def trace_launches(fn, names=PASS_KERNELS) -> dict[str, int]:
    """The launches of the kernels ``names`` (the large-K kernels by default)
    in one call of ``fn``, as a profiler trace of the device records them:
    kernel (with its template arguments) -> launches.  Empty where the
    profiler records no kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        hit = re.search(r"(\w+)(<[^()]*>)?\(", e.key)
        if hit and hit.group(1) in names:
            name = hit.group(1) + (hit.group(2) or "")
            counts[name] = counts.get(name, 0) + e.count
    return counts


def launch_text(counts: dict[str, int]) -> str:
    if not counts:
        return "kernel launches not measured (the profiler recorded no kernel)"
    return (f"{sum(counts.values())} kernel launches (device trace: "
            + ", ".join(f"{n} {k}" for k, n in sorted(counts.items())) + ")")


def phase_launch_trace(tag, rng, quads):
    """Launches a call, and so passes of the metrics through device memory,
    of the large-K update forms at the paths' shapes, from a profiler trace
    (the wrappers' counters count one a call); µs a pass of the depth-4
    forms' quads from ``phase_timing_quad``'s times (a shift pass's time
    included) over their ACS launches; the device operations of a steady
    push of each of path 7's streams.  Last, so that the profiler runs
    after every timing."""
    for name, fn, B in (("acs_update_tb", kernels.acs_update_tb, B_TB),
                        ("acs_update_tb2", kernels2.acs_update_tb2, B_TB2)):
        _, sym = noisy_symbols(soft8_spec(2), B, rng, 3)
        s, m = trb(sym), metrics0(CODE, soft8_spec(2), B)
        counts = trace_launches(lambda: fn(CODE, soft8_spec(2), m, s, s.shape[0]), TB_KERNELS)
        print(f"[{tag}] {name} K=7 B={B} T={s.shape[0]}: {launch_text(counts)} a call")
        del sym, s, m
    cas, s6 = VITERBI615, soft8_spec(6)
    _, sym = noisy_symbols(s6, B_CAS_LARGE, rng, 3, cas, CAS_BYTES)
    m = metrics0(cas, s6, B_CAS_LARGE, state_major=False)
    T = sym.shape[1]
    counts = trace_launches(lambda: large_k2.acs_update_large2(cas, s6, m, sym))
    print(f"[{tag}] acs_update_large2 cassini B={B_CAS_LARGE} T={T} (on chip, "
          f"{large_k2.chip_blocks(cas, B_CAS_LARGE)} blocks a frame): {launch_text(counts)} a call; "
          f"metric-traffic floor 1 pass {metric_pass_ms(B_CAS_LARGE, cas):.4f} ms (streaming, a "
          f"pass a pair: {(T // 2) * metric_pass_ms(B_CAS_LARGE, cas):.4f} ms)")
    ice, s8 = VITERBI224, soft8_spec(2)
    m_ice, sym_ice = quads["acs_update_large4"][0][2:4]
    k10, s7 = CodeSpec("k10r7", 10, 7, K10R7_POLYS), soft8_spec(7)
    m10 = metrics0(k10, s7, 3, state_major=False)
    sym10 = torch.from_numpy(rng.integers(-3, 4, size=(3, 21, 7)).astype(np.int32)).cuda()
    # acs_update_large in each form: the trace's launches a call must be the plan's.
    for code, numeric, mm, ss in ((cas, s6, m, sym[:, :T // 2]), (cas, s6, m, sym[:, :1]),
                                  (ice, s8, m_ice, sym_ice), (ice, s8, m_ice, sym_ice[:, :1]),
                                  (k10, s7, m10, sym10)):
        ss = ss.contiguous()
        p = large_k.plan(code, mm.shape[0], ss.shape[1])
        counts = trace_launches(lambda: large_k.acs_update_large(code, numeric, mm, ss))
        print(f"[{tag}] acs_update_large {code.name} B={mm.shape[0]} T={ss.shape[1]} ({p.form}): "
              f"{launch_text(counts)} a call; planned {p.launches}")
        if counts and sum(counts.values()) != p.launches:
            raise SystemExit(f"FAIL: acs_update_large {code.name} T={ss.shape[1]} launched "
                             f"{sum(counts.values())} kernels, planned {p.launches}")
    # Path 3's blocks of 41 and 46 steps: the remainder's shift comes from the last quad launch.
    for n in (41, 46):
        ss = sym_ice[:, :n].contiguous()
        counts = trace_launches(lambda: large_k4.acs_update_large4(ice, s8, m_ice, ss))
        print(f"[{tag}] acs_update_large4 ice B={B_ICE} T={n} (path 3's block): "
              f"{launch_text(counts)} a call")
    del m, sym, m10, sym10, m_ice, sym_ice
    # The decoder's whole-frame update on both routes: device operations of
    # any origin in one update (its reset, outside the trace, restored by
    # hand so that nothing is launched for it).
    for code, B, n_bytes, most in ((CODE, B_INPLACE, FRAME_BYTES, 2), (CODE, B_TB, FRAME_BYTES, 1),
                                   (VITERBI615, B_CAS_INPLACE, CAS_BYTES, 2)):
        _, sym = noisy_symbols(soft8_spec(code.R), B, rng, 3, code, n_bytes)
        dec = ViterbiDecoder(code, soft8_spec(code.R), B, "cuda")
        m_reset = dec.metrics

        def update():
            dec.metrics, dec._blocks, dec._steps = m_reset, [], 0
            dec.update(sym)

        n_ops, port, attempt, names = trace_ops(update)
        route = "in-place" if dispatch.use_inplace(code, B, "cuda") else "state-order"
        print(f"[{tag}] decoder {code.name} B={B} ({route}) whole-frame update: " + (
            "device operations not measured (the profiler recorded none)" if n_ops < 0 else
            f"{n_ops} device operations ({attempt}), of them the port's kernels "
            f"{json.dumps(port)}, the others {json.dumps(names)}; at most {most} expected: "
            f"{'met' if 0 <= n_ops <= most else 'missed'}"))
        del dec, sym, m_reset
    # Path 7's streams: device operations in a steady push (the third).
    for code, B, n, _, _ in STREAMS:
        _, noisy = noisy_symbols(soft8_spec(code.R), B, rng, 3, code, (3 * n) // 8 + 1)
        dec = StreamingDecoder(code, soft8_spec(code.R), B)
        for i in range(2):
            dec.push(noisy[:, i * n:(i + 1) * n])
        n_ops, port, attempt = trace_push(lambda: dec.push(noisy[:, 2 * n:3 * n]))
        print(f"[{tag}] stream {code.name} B={B} {n}-step pushes: " + (
            "device operations not measured (the profiler recorded none)" if n_ops < 0 else
            f"{n_ops} device operations a push ({attempt}), of them the port's kernels "
            f"{json.dumps(port)}") + (f"; at most 3 expected at K=7: "
                                      f"{'met' if 0 <= n_ops <= 3 else 'missed'}"
                                      if code.K == 7 else ""))
        del dec, noisy
    # Path 9's time-block shard body: device operations a call.
    B, OL = B_TB, 56
    _, noisy = noisy_symbols(soft8_spec(2), B, rng, 3, CODE, FRAME_BYTES)
    noisy = torch.nn.functional.pad(noisy, (0, 0, 0, (-noisy.shape[1]) % 8))
    for axes in ({"frame": 2, "time": 4}, {"time": 8}):
        mesh = parallel.Mesh(axes, "cuda")
        blk = mesh.shard(noisy, ("frame" if "frame" in axes else None, "time"))
        n_ops, port, attempt = trace_push(
            lambda: timeblock._time_block_shards(CODE, soft8_spec(2), mesh, blk, OL, "time"))
        print(f"[{tag}] parallel time blocks K=7 B={B} on {axes}, overlap {OL}: the shard body " + (
            "device operations not measured (the profiler recorded none)" if n_ops < 0 else
            f"{n_ops} device operations a call ({attempt}), of them the port's kernels "
            f"{json.dumps(port)}"))
        del blk, mesh
    del noisy
    pass_ms = metric_pass_ms(B_ICE, ice)
    for name, (args, body, extra, nq, quads_ms, ms) in quads.items():
        fn = getattr(large_k4, name)
        counts = trace_launches(lambda: fn(*args))
        alone = trace_launches(lambda: fn(ice, s8, args[2], body, *extra))
        passes = sum(n for k, n in alone.items() if not k.startswith("frame_"))
        T = args[3].shape[1]
        per_pass = f"{1e3 * quads_ms / passes:.2f} us a pass" if passes else "not measured"
        print(f"[{tag}] {name} ice B={B_ICE} T={T}: the whole call {ms:.4f} ms, "
              f"{launch_text(counts)}; its {nq} quads alone {quads_ms:.4f} ms in {passes} ACS "
              f"launches and {sum(alone.values()) - passes} shift passes (device trace) = "
              f"{per_pass}; metric-traffic floor {1e3 * pass_ms:.2f} us a pass "
              f"({2 * 4 * B_ICE * ice.num_states / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s), "
              f"{-(-T // 8)} passes at 8 steps a pass {-(-T // 8) * pass_ms:.4f} ms")
    torch.cuda.empty_cache()


def phase_fns_phases(tag, code, numeric, B, n_bytes, rng, label, chain_ks=()):
    """Update and chainback phase times of ``dispatch.phase_fns`` in the
    kernels' own layout (CUDA-event means after a warm-up); with
    ``chain_ks``, the traceback chain's time a link at those lengths, which
    agree when no link waits for the host."""
    T, nbits = code.transmit_bits(n_bytes), n_bytes * 8
    _, sym = noisy_symbols(numeric, B, rng, 3, code, n_bytes)
    init_fn, update_fn, chainback_fn, prepare_fn, make_cb_chain, _ = dispatch.phase_fns(
        code, numeric, nbits, B)
    prepared, m = prepare_fn(sym), init_fn(B)
    iters = 10 if code.K <= 9 else 3
    upd_ms = timed_ms(lambda: update_fn(m, prepared), iters)
    _, words, _ = update_fn(m, prepared)
    cb_ms = timed_ms(lambda: chainback_fn(words), iters)
    print(f"[{tag}] phase_fns {label} B={B} update phase {upd_ms:.4f} ms = "
          f"{B * T * code.R / upd_ms / 1e3:.1f} Msym/s; chainback phase {cb_ms:.4f} ms = "
          f"{B * nbits / cb_ms / 1e3:.4g} Mbit/s")
    if chain_ks:
        per_link = [timed_ms(lambda: make_cb_chain(k)(words), 3) / k for k in chain_ks]
        print(f"[{tag}] phase_fns {label} B={B} chainback chain, ms a link at "
              f"k={list(chain_ks)}: {', '.join(f'{x:.4f}' for x in per_link)}")
    del words
    torch.cuda.empty_cache()
    return upd_ms, cb_ms


def phase_timing_tb2(tag, rng, rows):
    """The depth-2 kernel at K=7 and K=9, B=1024, beside ``acs_update_tb`` and
    the in-place kernel on the same frames; then the phases of ``phase_fns``
    in the kernels' own layout: the in-place family at the runner's batches
    (beside the decoder's phases at K=7 and Cassini, whose difference is the
    layout copies), and the K <= 9 family with the in-place route off."""
    for key in (None, "k9"):  # K=7 soft8 1024-byte frames, K=9 soft16 512-byte frames
        args = compared_args("acs_update_tb2", key)
        code, numeric, m0, s, T = args
        B = B_TB2
        shape = f"K={code.K} B={B} T={T}"
        kernel_row(tag, rows, "acs_update_tb2", kernels2.acs_update_tb2,
                   kernels2.acs_update_tb2_ref, args, shape,
                   acs_bound_ms(B, T, code), 10, key=key)
        tb_ms = timed_ms(lambda: kernels.acs_update_tb(code, numeric, m0, s, T), 10)
        ip_ms = timed_ms(lambda: inplace.acs_update_inplace(code, numeric, m0, s, T, 0), 10)
        print(f"[{tag}] on the same frames, {shape}: acs_update_tb {tb_ms:.4f} ms, "
              f"acs_update_inplace {ip_ms:.4f} ms")
    torch.cuda.empty_cache()

    for code, n_bytes in ((CODE, FRAME_BYTES), (VITERBI47, 1024), (VITERBI29, 512),
                          (VITERBI49, 512), (VITERBI615, CAS_BYTES)):
        B = runner.DEFAULT_BATCH[code.name]
        numeric = soft8_spec(code.R)
        upd, cb = phase_fns_phases(tag, code, numeric, B, n_bytes, rng, f"{code.name} (in-place)",
                                   chain_ks=(4, 16) if code is CODE else ())
        if code in (CODE, VITERBI615):
            d_upd, d_cb = decoder_phases(tag, code, numeric, B, n_bytes, rng,
                                         f"{code.name} (in-place)")
            _, sym = noisy_symbols(numeric, B, rng, 3, code, n_bytes)
            dec = ViterbiDecoder(code, numeric, B, "cuda")
            m = dec.metrics
            T, iters = sym.shape[1], 10 if code is CODE else 3

            def update():  # from step 0, with nothing launched to get there
                dec.metrics, dec._blocks, dec._steps = m, [], 0
                dec.update(sym)

            queued = queued_ms(update, iters)
            kernel = queued_ms(lambda: inplace.acs_update_inplace(
                code, numeric, m.T, sym.permute(1, 2, 0), T, 0), iters)
            print(f"[{tag}] {code.name} B={B} glue around the kernels: decoder update {queued:.4f} "
                  f"ms queued (one call on an idle card {d_upd:.4f} ms), the kernel alone on the "
                  f"decoder's batch-major inputs {kernel:.4f} ms queued: {queued - kernel:.4f} ms "
                  f"({100 * (queued / kernel - 1):.1f} %; phase_fns update {upd:.4f} ms on "
                  f"[Tp, R, B]); chainback (decoder phase - phase_fns phase) {d_cb - cb:.4f} ms")
            del sym, m, dec
    with inplace_off():
        for code, n_bytes in ((CODE, FRAME_BYTES), (VITERBI29, 512)):
            for B in (512, B_TB2):
                route = "depth-2" if B >= 1024 else "state-order"
                phase_fns_phases(tag, code, soft8_spec(code.R), B, n_bytes, rng,
                                 f"{code.name} ({route}, in-place off)",
                                 chain_ks=(4, 16) if (code is CODE and B == B_TB2) else ())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.library()
    tag = card_tag()
    print(f"[{tag}] build: {_build.build_seconds():.2f} s in nvcc ({len(_build.SOURCES)} sources "
          f"in parallel), {time.perf_counter() - t0:.2f} s to load; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    rng = np.random.default_rng(SEED)
    lap = [time.perf_counter()]

    def done(what):
        now = time.perf_counter()
        print(f"[{tag}] -- {what}: {now - lap[0]:.1f} s")
        lap[0] = now

    errs = phase_kernels(tag, rng)
    done("K=7 comparisons")
    phase_kernels_large(tag, rng, errs)
    done("large-K and K=15 comparisons")
    phase_kernels_quad(tag, rng, errs)
    done("depth-4 comparisons")
    phase_kernels_walk(tag, rng, errs)
    done("walk comparisons")
    phase_kernels_u8(tag, rng, errs)
    done("u8 replica comparisons")
    phase_kernels_shard(tag, rng, errs)
    done("shard step comparisons")
    phase_kernels_tb2(tag, rng, errs)
    done("depth-2 comparisons")
    phase_kernels_tb_forms(tag, rng, errs)
    done("state-order forms comparisons")
    phase_kernels_inplace_forms(tag, rng, errs)
    done("in-place forms comparisons")
    phase_kernels_views(tag, errs)
    done("whole-frame kernels on batch-major views")
    launches = phase_decode(tag, rng, errs)
    done("the nine paths")
    phase_canary(tag, rng)
    done("the in-place canary at K=15 B=512")
    rows = phase_timing(tag, rng)
    done("K=7 and K=9 timing")
    phase_timing_large(tag, rng, rows)
    done("Cassini timing")
    quads = phase_timing_quad(tag, rng, rows)
    lat = phase_timing_walk(tag, rows)
    done("ICE timing")
    phase_timing_u8(tag, rows)
    done("u8 replica timing")
    phase_timing_shard(tag, rows, lat)
    done("shard step and walk timing")
    phase_timing_tb2(tag, rng, rows)
    done("depth-2 and phase_fns timing")
    phase_launch_trace(tag, rng, quads)
    done("launches a call (device trace)")
    print(f"[{tag}] chip_smoke: {time.perf_counter() - t0:.1f} s in all")

    for name, e in FORM_ERRS.items():
        errs[name] = max(errs[name], e)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name], **rows[name],
         "library_ms": None}
        for name in REPLACES]}
    print(json.dumps(line))
    print(tag)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
