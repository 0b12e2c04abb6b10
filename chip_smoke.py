"""Drive the PyTorch/CUDA port's decode paths on one GPU and check them.

    python3 chip_smoke.py

Builds the CUDA kernels from ``csrc/`` (one ``nvcc`` per source, started
together), holds each of the six kernels against its plain PyTorch version on
the card, then drives three decode paths through
``ViterbiDecoder(backend="cuda")``, each with the launch counts zeroed just
before it and read just after:

* VITERBI27 (K=7, r=1/2) soft8, 1024-byte frames: B=512 (the in-place pair)
  and B=64 (the state-order pair);
* VITERBI615 (K=15, r=1/6, Cassini) soft8, 256-byte frames: B=256 (the
  in-place pair) and B=64 (the large-K pair kernel, whole frames and in two
  blocks of 1031 steps, whose odd tails run the single-step kernel);
* VITERBI224 (K=24, r=1/2, ICE) soft8, 8-byte frames at B=8 (the large-K
  pair kernel and its odd tail).

Then it times the kernels and the decoders' phases with CUDA events.  Every
number line carries the card's name and power limit.  The last three lines
are a JSON object listing the kernels, the card's name and power limit, and a
JSON object ``{"ok": true, "device": ...}``.

Exits non-zero, printing no result, without a CUDA device or without the
port's package beside it.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ka9q_viterbi_comparison_tpu_torch import (  # noqa: E402
    VITERBI27,
    VITERBI224,
    VITERBI615,
    ViterbiDecoder,
    soft8_spec,
    soft16_spec,
)
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    dispatch,
    inplace,
    kernels,
    large_k,
    large_k2,
)
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors  # noqa: E402

SEED = 20261016
FRAME_BYTES = 1024          # K=7 frames
B_INPLACE, B_TB = 512, 64   # K=7 batches
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
          ("acs_update_tb", "chainback_tb", "acs_update_inplace", "chainback_inplace")}
SOURCE.update({name: "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_large.cu" for name in
               ("acs_update_large2", "acs_update_large")})
REPLACES = {
    "acs_update_tb": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py:227",
    "chainback_tb": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py:361",
    "acs_update_inplace": "ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py:468",
    "chainback_inplace": "ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py:630",
    "acs_update_large2": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k2.py:340",
    "acs_update_large": "ka9q_viterbi_comparison_tpu/ops/pallas/large_k.py:167",
}


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
    print(f"{name}: max_abs_err {err} (offset of frame 0: {int(got[2][0])})")
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
    """The three decode paths; returns the launches of each kernel summed
    over the paths."""
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
                            rng, ("acs_update_large2", "acs_update_large")))
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


def decoder_phases(tag, code, numeric, B, n_bytes, rng, label):
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
    msym = B * T * code.R / (upd_ms * 1e-3) / 1e6
    mbit = B * nbits / (cb_ms * 1e-3) / 1e6
    print(f"[{tag}] decoder {label} B={B} update phase {upd_ms:.4f} ms = {msym:.1f} Msym/s; "
          f"chainback phase {cb_ms:.4f} ms = {mbit:.1f} Mbit/s")


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
    launches = phase_decode(tag, rng)
    rows = phase_timing(tag, rng)
    phase_timing_large(tag, rng, rows)
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
