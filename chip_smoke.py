"""Drive the PyTorch/CUDA port's decode paths on one GPU and check them.

    python3 chip_smoke.py

Builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, started
together), holds each of the ten kernels against its plain PyTorch version on
the card, then drives six paths -- through ``ViterbiDecoder(backend="cuda")``,
``dispatch.phase_fns`` and the benchmark runner -- each with the launch counts
zeroed just before it and read just after:

* VITERBI27 (K=7, r=1/2) soft8, 1024-byte frames: B=512 (the in-place pair)
  and B=64 (the state-order pair);
* VITERBI615 (K=15, r=1/6, Cassini) soft8, 256-byte frames: B=256 (the
  in-place pair) and B=64 (the large-K pair kernel, whole frames and in two
  blocks of 1031 steps, whose odd tails run the single-step kernel);
* VITERBI224 (K=24, r=1/2, ICE) soft8, 8-byte frames (T = 87) at B=8: the
  depth-4 quad kernel (21 quads), its three-step remainder on the pair and
  step kernels, the portable walk;
* the same ICE frames through ``phase_fns``: the update that returns the
  byte-packed f8 walk table (the quad kernel in fields mode over ten quad
  pairs, after 7 lead steps on the pair and step kernels) and the
  8-steps-a-fetch table walk; and, asked for 7 of the 8 bytes, the f4 route;
* VITERBI27 soft8, 1024-byte frames at B=1024 with the in-place route off
  (``KA9Q_TORCH_INPLACE=0`` for this path only): the depth-2 state-order
  kernel ``acs_update_tb2`` and ``chainback_tb``, through the decoder and
  through ``phase_fns`` with its chains of three links;
* the benchmark runner (``harness.runner.run_matrix``, ``backends=["cuda"]``):
  all six codes at its default batches and the reference's frame sizes,
  every numeric spec, 16 rows of reference-schema JSON with bit error rate 0.

Then it times the kernels and the decoders' phases with CUDA events.  Every
number line carries the card's name and power limit.  The last three lines
are a JSON object listing the kernels, the card's name and power limit, and a
JSON object ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
port's package beside it.  Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
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
    ViterbiDecoder,
    soft8_spec,
    soft16_spec,
)
from ka9q_viterbi_comparison_tpu_torch.harness import runner  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops import radix_planes  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    dispatch,
    inplace,
    kernels,
    kernels2,
    large_k,
    large_k2,
    large_k4,
)
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.utils.bits import bits_to_bytes, count_bit_errors  # noqa: E402

SEED = 20261016
FRAME_BYTES = 1024          # K=7 frames
B_INPLACE, B_TB = 512, 64   # K=7 batches
B_TB2 = 1024                # the depth-2 kernel's batch (K <= 9, in-place route off)
CAS_BYTES = 256             # Cassini frames (T = 2062 steps)
B_CAS_INPLACE, B_CAS_LARGE = 256, 64
ICE_BYTES, B_ICE = 8, 8     # ICE frames (T = 87 steps)
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
}
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


def compare_update(name, fn, ref, args, T):
    """Run kernel and plain version on the same inputs; metrics and words
    [:T] must be identical.  Returns (max_abs_err, kernel outputs)."""
    m_k, d_k = fn(*args)
    m_r, d_r = ref(*args)
    torch.cuda.synchronize()
    err = max(max_abs_err(m_k, m_r), max_abs_err(d_k[:T], d_r[:T]))
    print(f"{name}: max_abs_err {err}")
    return check(name, err), (m_k, d_k)


def compare_walk(name, fn, ref, args, T):
    bits_k, bits_r = fn(*args), ref(*args)
    torch.cuda.synchronize()
    nw = -(-T // 32)
    err = max_abs_err(bits_k[:nw], bits_r[:nw])
    print(f"{name}: max_abs_err {err}")
    return check(name, err)


def compare_large(name, fn, ref, args, kwargs=None):
    """A large-K update and its plain version: metrics, words and offset
    must be identical.  Returns (max_abs_err, kernel outputs)."""
    kwargs = kwargs or {}
    got = fn(*args, **kwargs)
    want = ref(*args, **kwargs)
    torch.cuda.synchronize()
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    print(f"{name}: max_abs_err {err} (offset of frame 0: {int(got[-1][0])})")
    return check(name, err), got


def phase_kernels(tag, rng):
    """Each K=7 kernel against its plain version at the main path's shapes."""
    soft8 = soft8_spec(2)
    T = CODE.transmit_bits(FRAME_BYTES)
    errs = {k: 0 for k in _build.LAUNCHES}

    def run_pairs(numeric, B, noise, label):
        _, sym = noisy_symbols(numeric, B, rng, noise)
        s = trb(sym)
        m0 = metrics0(CODE, numeric, B)
        end = torch.from_numpy(rng.integers(0, CODE.num_states, size=(1, B)).astype(np.int32)).cuda()
        e, (_, d) = compare_update(f"acs_update_tb {label}", kernels.acs_update_tb,
                                   kernels.acs_update_tb_ref, (CODE, numeric, m0, s, T), T)
        errs["acs_update_tb"] = max(errs["acs_update_tb"], e)
        e = compare_walk(f"chainback_tb {label}", kernels.chainback_tb, kernels.chainback_tb_ref,
                         (CODE, d, end, T), T)
        errs["chainback_tb"] = max(errs["chainback_tb"], e)
        e, (_, d) = compare_update(f"acs_update_inplace {label}", inplace.acs_update_inplace,
                                   inplace.acs_update_inplace_ref, (CODE, numeric, m0, s, T, 0), T)
        errs["acs_update_inplace"] = max(errs["acs_update_inplace"], e)
        e = compare_walk(f"chainback_inplace {label}", inplace.chainback_inplace,
                         inplace.chainback_inplace_ref, (CODE, d, end, T, 0), T)
        errs["chainback_inplace"] = max(errs["chainback_inplace"], e)
        return s, m0

    run_pairs(soft8, B_TB, 4, f"soft8 B={B_TB}")
    s, m0 = run_pairs(soft8, B_INPLACE, 4, f"soft8 B={B_INPLACE}")
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
    e, (_, words, _) = compare_large(f"acs_update_large2 cassini soft8 B={B_CAS_LARGE} T={T}",
                                     large_k2.acs_update_large2, large_k2.acs_update_large2_ref,
                                     (cas, soft8, m0, sym))
    note("acs_update_large2", e)
    # A block of 788 pairs: the second renormalisation follows the last pair,
    # so frame_sub_kernel writes the returned metrics.
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
                                      kernels.chainback_tb_ref, (cas, w, end, T), T))
    # soft16: int32 storage, no renormalisation; time-major words.
    s16 = soft16_spec(6)
    assert large_k2.renorm_schedule(cas, s16, T) == (torch.int32, 0)
    _, sym16 = noisy_symbols(s16, 16, rng, 160, cas, CAS_BYTES)
    e, _ = compare_large("acs_update_large2 cassini soft16 B=16 time-major",
                         large_k2.acs_update_large2, large_k2.acs_update_large2_ref,
                         (cas, s16, metrics0(cas, s16, 16, state_major=False), sym16),
                         {"time_major": True})
    note("acs_update_large2", e)
    # The step kernel on an odd-length block (half a frame: 1031 steps).
    half = T // 2
    e, _ = compare_large(f"acs_update_large cassini soft8 B={B_CAS_LARGE} T={half}",
                         large_k.acs_update_large, large_k.acs_update_large_ref,
                         (cas, soft8, m0, sym[:, :half].contiguous()))
    note("acs_update_large", e)
    # ICE K=24 (2^23 states) at B=2, T=7: three pairs and the odd tail.
    ice, s8 = VITERBI224, soft8_spec(2)
    sym_ice = torch.from_numpy(rng.integers(-3, 4, size=(2, 7, 2)).astype(np.int32)).cuda()
    m_ice = metrics0(ice, s8, 2, state_major=False) + torch.randint(
        0, 9, (2, ice.num_states), dtype=torch.int32, device="cuda")
    e, _ = compare_large("acs_update_large2 ice B=2 T=7", large_k2.acs_update_large2,
                         large_k2.acs_update_large2_ref, (ice, s8, m_ice, sym_ice))
    note("acs_update_large2", e)
    e, _ = compare_large("acs_update_large ice B=2 T=7", large_k.acs_update_large,
                         large_k.acs_update_large_ref, (ice, s8, m_ice, sym_ice))
    note("acs_update_large", e)
    del m_ice
    # Both at the ICE decode path's own shapes: B=8, 87 steps, reset metrics.
    _, sym_ice = noisy_symbols(s8, B_ICE, rng, 3, ice, ICE_BYTES)
    m_ice = metrics0(ice, s8, B_ICE, state_major=False)
    T_ice = sym_ice.shape[1]
    for name, mod in (("acs_update_large2", large_k2), ("acs_update_large", large_k)):
        e, _ = compare_large(f"{name} ice B={B_ICE} T={T_ice}", getattr(mod, name),
                             getattr(mod, name + "_ref"), (ice, s8, m_ice, sym_ice))
        note(name, e)
    del m_ice, sym_ice
    # The in-place pair at K=15, B=256, a whole frame.
    _, sym = noisy_symbols(soft8, B_CAS_INPLACE, rng, 3, cas, CAS_BYTES)
    s = trb(sym)
    m0 = metrics0(cas, soft8, B_CAS_INPLACE)
    e, (_, d) = compare_update(f"acs_update_inplace cassini B={B_CAS_INPLACE}",
                               inplace.acs_update_inplace, inplace.acs_update_inplace_ref,
                               (cas, soft8, m0, s, T, 0), T)
    note("acs_update_inplace", e)
    end = torch.zeros((1, B_CAS_INPLACE), dtype=torch.int32, device="cuda")
    note("chainback_inplace", compare_walk(f"chainback_inplace cassini B={B_CAS_INPLACE}",
                                           inplace.chainback_inplace,
                                           inplace.chainback_inplace_ref,
                                           (cas, d, end, T, 0), T))
    torch.cuda.empty_cache()
    print(f"[{tag}] large-K kernels and K=15 shapes vs plain versions: all bit-identical")


def phase_kernels_quad(tag, rng, errs):
    """The depth-4 quad kernel in its three forms (words, f4 table, f8
    table) and the pair kernel's G_2 planes, each against its plain
    version: at the ICE paths' own shapes, at ICE with soft16 symbols so
    that every renormalisation cadence fires, at the remainders 1 and 2, and
    at a small K (time-major words, R=1)."""
    ice, s8, s16 = VITERBI224, soft8_spec(2), soft16_spec(2)
    forms = ("acs_update_large4", "acs_update_large4_fields", "acs_update_large4_fields8")

    def note(name, e):
        errs[name] = max(errs[name], e)

    def three(label, code, numeric, m, sym, leads=(ICE_LEAD4, ICE_LEAD8)):
        out = {}
        for name, lead in zip(forms, ((), (leads[0],), (leads[1],))):
            e, got = compare_large(f"{name} {label}", getattr(large_k4, name),
                                   getattr(large_k4, name + "_ref"), (code, numeric, m, sym, *lead))
            note(name, e)
            out[name] = got[0]
            del got
            torch.cuda.empty_cache()
        return out

    # The ICE paths' shapes: B=8, T=87, soft8 (no renormalisation).
    _, sym = noisy_symbols(s8, B_ICE, rng, 3, ice, ICE_BYTES)
    T = sym.shape[1]
    assert large_k4.renorm_schedule4(ice, s8, T)[1] == 0
    three(f"ice soft8 B={B_ICE} T={T}", ice, s8, metrics0(ice, s8, B_ICE, state_major=False), sym)
    # Remainders 1 and 2 (T=87 has 3) from lifted metrics.
    m_lift = metrics0(ice, s8, 2, state_major=False) + torch.randint(
        0, 9, (2, ice.num_states), dtype=torch.int32, device="cuda")
    for t in (85, 86):
        e, _ = compare_large(f"acs_update_large4 ice soft8 B=2 T={t}", large_k4.acs_update_large4,
                             large_k4.acs_update_large4_ref,
                             (ice, s8, m_lift, sym[:2, :t].contiguous()))
        note("acs_update_large4", e)
    del m_lift
    # soft16: every 7 quads (21 quads: the third shift follows the last quad
    # and runs frame_sub_kernel) and every 3 quad pairs.
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
    def one(code, numeric, B, n_bytes, noise, t_cuts=(0,)):
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
                                           (code, numeric, m0, s, t), t)
            m_t, d_t = kernels.acs_update_tb(code, numeric, m0, s, t)
            torch.cuda.synchronize()
            e = max(e, check(label + " vs the acs_update_tb kernel",
                             max(max_abs_err(m_k, m_t), max_abs_err(d_k[:t], d_t[:t]))))
            errs["acs_update_tb2"] = max(errs["acs_update_tb2"], e)

    # T = 8198: 8197 is odd (one step A alone); 8185 ends 25 steps into a stage.
    one(CODE, soft8_spec(2), B_TB2, FRAME_BYTES, 4, (0, 1, 13))
    one(VITERBI29, soft16_spec(2), B_TB2, 512, 160)
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
        want = (("acs_update_large4_fields8",) if code.K > 15 else
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
    return total


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
    for name in ("acs_update_large4_fields8", "acs_update_large4_fields", "acs_update_large2",
                 "acs_update_large"):
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


def phase_decode(tag, rng):
    """The six paths; returns the launches of each kernel summed over the
    paths."""
    paths = [
        drive_path(tag, "K=7", CODE, soft8_spec(2), FRAME_BYTES, [(B_INPLACE, None), (B_TB, None)],
                   rng, ("acs_update_tb", "chainback_tb", "acs_update_inplace",
                         "chainback_inplace")),
        drive_path(tag, "Cassini", VITERBI615, soft8_spec(6), CAS_BYTES,
                   [(B_CAS_INPLACE, None), (B_CAS_LARGE, None),
                    (B_CAS_LARGE, (VITERBI615.transmit_bits(CAS_BYTES) // 2,) * 2)],
                   rng, ("acs_update_inplace", "chainback_inplace", "acs_update_large2",
                         "acs_update_large", "chainback_tb")),
    ]
    paths.append(drive_path(tag, "ICE", VITERBI224, soft8_spec(2), ICE_BYTES, [(B_ICE, None)],
                            rng, ("acs_update_large4", "acs_update_large2", "acs_update_large")))
    paths.append(drive_phase_fns(tag, rng))
    paths.append(drive_tb2_path(tag, rng))
    paths.append(drive_runner(tag))
    launches = {name: sum(p[name] for p in paths) for name in _build.LAUNCHES}
    zero = [name for name, n in launches.items() if n == 0]
    if zero:
        raise SystemExit(f"FAIL: kernels {zero} were not launched on any path")
    return launches


def kernel_row(tag, rows, name, fn, ref, args, shape, bnd, iters, key=None, kwargs=None):
    kwargs = kwargs or {}
    ms = timed_ms(lambda: fn(*args, **kwargs), iters)
    plain_ms = timed_ms(lambda: ref(*args, **kwargs), 1)
    row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
    if key:
        rows.setdefault(name, {})[key] = row
    else:
        rows[name] = row
    print(f"[{tag}] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
          f"bound {bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
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

    for B, pair in ((B_TB, "tb"), (B_INPLACE, "inplace")):
        _, sym = noisy_symbols(numeric, B, rng, 4)
        s = trb(sym)
        m0 = metrics0(CODE, numeric, B)
        end = torch.zeros((1, B), dtype=torch.int32, device="cuda")
        shape = f"K=7 B={B} T={T}"
        if pair == "tb":
            _, d = kernels.acs_update_tb(CODE, numeric, m0, s, T)
            kernel_row(tag, rows, "acs_update_tb", kernels.acs_update_tb, kernels.acs_update_tb_ref,
                       (CODE, numeric, m0, s, T), shape, acs_bound_ms(B, T), 20)
            kernel_row(tag, rows, "chainback_tb", kernels.chainback_tb, kernels.chainback_tb_ref,
                       (CODE, d, end, T), shape, chainback_bound_ms(B, T, False), 20)
        else:
            _, d = inplace.acs_update_inplace(CODE, numeric, m0, s, T, 0)
            kernel_row(tag, rows, "acs_update_inplace", inplace.acs_update_inplace,
                       inplace.acs_update_inplace_ref, (CODE, numeric, m0, s, T, 0), shape,
                       acs_bound_ms(B, T), 20)
            kernel_row(tag, rows, "chainback_inplace", inplace.chainback_inplace,
                       inplace.chainback_inplace_ref, (CODE, d, end, T, 0), shape,
                       chainback_bound_ms(B, T, True), 20)
    decoder_phases(tag, CODE, numeric, B_INPLACE, FRAME_BYTES, rng,
                   f"K=7 ({'in-place' if dispatch.use_inplace(CODE, B_INPLACE, 'cuda') else 'state-order'})")
    return rows


def phase_timing_large(tag, rng, rows):
    """The large-K kernels at the Cassini path's shapes (the pair kernel on
    a whole B=64 frame, the step kernel on the one-step tail of a block, and
    on a 1031-step block for its per-step rate), the K=7 kernels' K=15
    shapes, and the Cassini decoder's phases."""
    cas, soft8 = VITERBI615, soft8_spec(6)
    T = cas.transmit_bits(CAS_BYTES)
    B = B_CAS_LARGE
    _, sym = noisy_symbols(soft8, B, rng, 3, cas, CAS_BYTES)
    m0 = metrics0(cas, soft8, B, state_major=False)
    ms = kernel_row(tag, rows, "acs_update_large2", large_k2.acs_update_large2,
                    large_k2.acs_update_large2_ref, (cas, soft8, m0, sym),
                    f"cassini B={B} T={T}", acs_bound_ms(B, T, cas), 10)
    streamed = (T // 2) * 2 * B * cas.num_states * 4
    print(f"[{tag}] acs_update_large2 cassini B={B}: metric traffic of one read and one write "
          f"a pair {streamed / 1e9:.3f} GB = {streamed / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; {1e3 * ms / (T // 2):.3f} us a pair")
    tail = sym[:, T - 1:].contiguous()
    kernel_row(tag, rows, "acs_update_large", large_k.acs_update_large,
               large_k.acs_update_large_ref, (cas, soft8, m0, tail), f"cassini tail B={B} T=1",
               acs_bound_ms(B, 1, cas), 50)
    half = T // 2
    ms = kernel_row(tag, rows, "acs_update_large", large_k.acs_update_large,
                    large_k.acs_update_large_ref, (cas, soft8, m0, sym[:, :half].contiguous()),
                    f"cassini B={B} T={half}", acs_bound_ms(B, half, cas), 5, key="block")
    print(f"[{tag}] acs_update_large cassini B={B}: {1e3 * ms / half:.3f} us a step")

    _, words, _ = large_k2.acs_update_large2(cas, soft8, m0, sym)
    w = words.permute(1, 2, 0).contiguous()
    end = torch.zeros((1, B), dtype=torch.int32, device="cuda")
    kernel_row(tag, rows, "chainback_tb", kernels.chainback_tb, kernels.chainback_tb_ref,
               (cas, w, end, T), f"cassini B={B} T={T}", chainback_bound_ms(B, T, False), 10,
               key="k15")
    del words, w
    Bi = B_CAS_INPLACE
    _, sym = noisy_symbols(soft8, Bi, rng, 3, cas, CAS_BYTES)
    s = trb(sym)
    m0 = metrics0(cas, soft8, Bi)
    _, d = inplace.acs_update_inplace(cas, soft8, m0, s, T, 0)
    end = torch.zeros((1, Bi), dtype=torch.int32, device="cuda")
    kernel_row(tag, rows, "acs_update_inplace", inplace.acs_update_inplace,
               inplace.acs_update_inplace_ref, (cas, soft8, m0, s, T, 0),
               f"cassini B={Bi} T={T}", acs_bound_ms(Bi, T, cas), 3, key="k15")
    kernel_row(tag, rows, "chainback_inplace", inplace.chainback_inplace,
               inplace.chainback_inplace_ref, (cas, d, end, T, 0), f"cassini B={Bi} T={T}",
               chainback_bound_ms(Bi, T, True), 10, key="k15")
    del d
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
    """The three forms of the quad kernel at the ICE paths' shapes (B=8,
    T=87), the pair kernel on the same steps beside them, and the phases of
    the ICE decoder and of ``phase_fns``."""
    ice, s8, B = VITERBI224, soft8_spec(2), B_ICE
    _, sym = noisy_symbols(s8, B, rng, 3, ice, ICE_BYTES)
    T = sym.shape[1]
    m0 = metrics0(ice, s8, B, state_major=False)
    shape = f"ice B={B} T={T}"
    quad_traffic = 2 * B * ice.num_states * 4
    for name, lead, bnd in (
            ("acs_update_large4", None, acs_bound_ms(B, T, ice)),
            ("acs_update_large4_fields", ICE_LEAD4, fields_bound_ms(B, T, ICE_LEAD4, ice)),
            ("acs_update_large4_fields8", ICE_LEAD8, fields_bound_ms(B, T, ICE_LEAD8, ice))):
        args = (ice, s8, m0, sym) if lead is None else (ice, s8, m0, sym, lead)
        label = shape if lead is None else f"{shape} lead={lead}"
        ms = kernel_row(tag, rows, name, getattr(large_k4, name), getattr(large_k4, name + "_ref"),
                        args, label, bnd, 5)
        torch.cuda.empty_cache()
        # The quad launches alone: the same call without its remainder or lead steps.
        nq = (T - (lead or 0)) // 4
        if lead is None:
            whole = sym[:, :4 * nq].contiguous()
            quads_ms = timed_ms(lambda: large_k4.acs_update_large4(ice, s8, m0, whole), 5)
        else:
            rest = sym[:, lead:].contiguous()
            quads_ms = timed_ms(lambda: getattr(large_k4, name)(ice, s8, m0, rest, 0), 5)
        print(f"[{tag}] {name} {shape}: {nq} quad launches alone {quads_ms:.4f} ms = "
              f"{1e3 * quads_ms / nq:.2f} us a launch; metric traffic of one read and one write a "
              f"quad {quad_traffic / 1e6:.1f} MB = {quad_traffic / HBM_BYTES_PER_S * 1e6:.2f} us "
              f"at {HBM_BYTES_PER_S / 1e12} TB/s; the whole call {ms:.4f} ms")
    ms = timed_ms(lambda: large_k2.acs_update_large2(ice, s8, m0, sym), 5)
    print(f"[{tag}] acs_update_large2 {shape} (the pair kernel on the same steps, not on the "
          f"path): kernel {ms:.4f} ms = {1e3 * ms / (T // 2):.2f} us a pair, bound "
          f"{acs_bound_ms(B, T, ice)[0]:.4f} ms")
    del m0
    torch.cuda.empty_cache()
    decoder_phases(tag, ice, s8, B, ICE_BYTES, rng, "ICE (depth-4 words, portable walk)",
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
    for code, n_bytes, key in ((CODE, FRAME_BYTES, None), (VITERBI29, 512, "k9")):
        numeric, B = soft8_spec(code.R), B_TB2
        _, sym = noisy_symbols(numeric, B, rng, 4, code, n_bytes)
        s, m0 = trb(sym), metrics0(code, numeric, B)
        T = s.shape[0]
        shape = f"K={code.K} B={B} T={T}"
        kernel_row(tag, rows, "acs_update_tb2", kernels2.acs_update_tb2,
                   kernels2.acs_update_tb2_ref, (code, numeric, m0, s, T), shape,
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
            print(f"[{tag}] {code.name} B={B} layout copies (decoder phase - phase_fns phase): "
                  f"update {d_upd - upd:.4f} ms, chainback {d_cb - cb:.4f} ms")
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
    errs = phase_kernels(tag, rng)
    phase_kernels_large(tag, rng, errs)
    phase_kernels_quad(tag, rng, errs)
    phase_kernels_tb2(tag, rng, errs)
    launches = phase_decode(tag, rng)
    rows = phase_timing(tag, rng)
    phase_timing_large(tag, rng, rows)
    phase_timing_quad(tag, rng, rows)
    phase_timing_tb2(tag, rng, rows)
    print(f"[{tag}] chip_smoke: {time.perf_counter() - t0:.1f} s in all")

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
