"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Decodes VITERBI27 (K=7, r=1/2) soft8 frames of 1024 bytes through
``ViterbiDecoder(backend="cuda")`` at B=512 (the in-place kernel pair) and
B=64 (the state-order pair), after building the CUDA kernels from ``csrc/``
and holding each kernel against its plain PyTorch version on the card.  Then
it times the kernels and the decoder's phases with CUDA events.  Every number
line carries the card's name and power limit.  The last two lines are a JSON
object listing the kernels and a JSON object ``{"ok": true, "device": ...}``.

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

from ka9q_viterbi_comparison_tpu_torch import VITERBI27, ViterbiDecoder, soft8_spec, soft16_spec  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, dispatch, inplace, kernels  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors  # noqa: E402

SEED = 20261016
FRAME_BYTES = 1024
B_INPLACE, B_TB = 512, 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# 132 SMs x 64 INT32 lanes x 1.98 GHz x 2 (multiply-add) -- the data sheet's
# int32 rate; every operation counted below is one int32 operation.
INT32_OPS_PER_S = 33.5e12

CODE = VITERBI27


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def noisy_symbols(numeric, batch, rng, noise):
    """Encoded random frames plus uniform integer noise in [-noise, noise],
    clipped to the rails: ``(data [B, N] uint8, symbols [B, T, R] int32 on the card)``."""
    data = rng.integers(0, 256, size=(batch, FRAME_BYTES), dtype=np.uint8)
    clean = encode_frames(CODE, numeric, torch.from_numpy(data)).numpy()
    sym = clean + rng.integers(-noise, noise + 1, size=clean.shape) if noise else clean
    sym = np.clip(sym, numeric.soft_low, numeric.soft_high).astype(np.int32)
    return data, torch.from_numpy(sym).cuda().reshape(batch, -1, CODE.R)


def trb(sym_btr):
    return sym_btr.permute(1, 2, 0).contiguous()


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two int32 tensors read as uint32 words."""
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


def acs_bound_ms(B, T) -> tuple[float, str]:
    """Least time of one ACS sweep: bytes = symbols in + metrics in and out +
    words out; operations per state and step = 2R penalty terms + 2 adds +
    compare + select + 1 packing = 2R + 5."""
    S, W, R = CODE.num_states, CODE.decision_words, CODE.R
    nbytes = 4 * B * (T * R + 2 * S + T * W)
    ops = B * T * S * (2 * R + 5)
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


def phase_kernels(tag, rng):
    """Each kernel against its plain version at the main path's shapes."""
    soft8 = soft8_spec(2)
    T = CODE.transmit_bits(FRAME_BYTES)
    errs = {k: 0 for k in _build.LAUNCHES}

    def metrics0(B, numeric):
        m = torch.full((CODE.num_states, B), numeric.initial_margin, dtype=torch.int32,
                       device="cuda")
        m[0] = 0
        return m

    def run_pairs(numeric, B, noise, label):
        _, sym = noisy_symbols(numeric, B, rng, noise)
        s = trb(sym)
        m0 = metrics0(B, numeric)
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
    T1 = 4099
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
    print(f"[{tag}] kernels vs plain versions: all bit-identical")
    return errs


def phase_decode(tag, rng):
    """The main path through the user's entry point, with launch counts."""
    numeric = soft8_spec(2)
    nbits = FRAME_BYTES * 8
    frames = {B: (noisy_symbols(numeric, B, rng, 0), noisy_symbols(numeric, B, rng, 3))
              for B in (B_INPLACE, B_TB)}
    results = {}
    _build.reset_launch_counts()
    for B, ((_, clean), (_, noisy)) in frames.items():
        dec = ViterbiDecoder(CODE, numeric, batch=B, backend="cuda")
        dec.update(clean)
        decoded, pm = dec.chainback(nbits), dec.path_metric(0)
        dec.reset()
        dec.update(noisy)
        results[B] = (decoded, pm, dec.chainback(nbits))
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"main path launches: {json.dumps(launches)}")
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"FAIL: kernel {name} was not launched on the main path")

    for B, ((data, _), (noisy_data, noisy)) in frames.items():
        decoded, pm, decoded_noisy = results[B]
        errors = count_bit_errors(decoded, data)
        ref = ViterbiDecoder(CODE, numeric, B, "torch")
        ref.update(noisy)
        ref_out = ref.chainback(nbits)
        same = bool(torch.equal(decoded_noisy, ref_out))
        pm_ok = bool((pm == 0).all())
        print(f"[{tag}] decode B={B} {FRAME_BYTES}-byte frames: noiseless bit errors {errors}, "
              f"path metric 0 on all frames {pm_ok}, noisy equal to backend=torch {same}, "
              f"noisy bit errors {count_bit_errors(decoded_noisy, noisy_data)}")
        if errors or not pm_ok or not same or decoded.shape != (B, FRAME_BYTES):
            raise SystemExit(f"FAIL: end-to-end decode at B={B}")
    return launches


def phase_timing(tag, rng):
    numeric = soft8_spec(2)
    T = CODE.transmit_bits(FRAME_BYTES)
    nbits = FRAME_BYTES * 8
    rows = {}

    def kernel_row(name, fn, ref, args, B, bnd, iters):
        ms = timed_ms(lambda: fn(*args), iters)
        plain_ms = timed_ms(lambda: ref(*args), 1)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"[{tag}] {name} B={B} T={T}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")

    for B, pair in ((B_TB, "tb"), (B_INPLACE, "inplace")):
        _, sym = noisy_symbols(numeric, B, rng, 4)
        s = trb(sym)
        m0 = torch.full((CODE.num_states, B), numeric.initial_margin, dtype=torch.int32,
                        device="cuda")
        m0[0] = 0
        end = torch.zeros((1, B), dtype=torch.int32, device="cuda")
        if pair == "tb":
            _, d = kernels.acs_update_tb(CODE, numeric, m0, s, T)
            kernel_row("acs_update_tb", kernels.acs_update_tb, kernels.acs_update_tb_ref,
                       (CODE, numeric, m0, s, T), B, acs_bound_ms(B, T), 20)
            kernel_row("chainback_tb", kernels.chainback_tb, kernels.chainback_tb_ref,
                       (CODE, d, end, T), B, chainback_bound_ms(B, T, False), 20)
        else:
            _, d = inplace.acs_update_inplace(CODE, numeric, m0, s, T, 0)
            kernel_row("acs_update_inplace", inplace.acs_update_inplace,
                       inplace.acs_update_inplace_ref, (CODE, numeric, m0, s, T, 0), B,
                       acs_bound_ms(B, T), 20)
            kernel_row("chainback_inplace", inplace.chainback_inplace,
                       inplace.chainback_inplace_ref, (CODE, d, end, T, 0), B,
                       chainback_bound_ms(B, T, True), 20)

    # The decoder's phases at B=512 (layout changes included).
    _, sym = noisy_symbols(numeric, B_INPLACE, rng, 4)
    dec = ViterbiDecoder(CODE, numeric, B_INPLACE, "cuda")
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
    cb_ms = timed_ms(lambda: dec.chainback(nbits), 10)
    msym = B_INPLACE * T * CODE.R / (upd_ms * 1e-3) / 1e6
    mbit = B_INPLACE * nbits / (cb_ms * 1e-3) / 1e6
    print(f"[{tag}] decoder B={B_INPLACE} update phase {upd_ms:.4f} ms = {msym:.1f} Msym/s; "
          f"chainback phase {cb_ms:.4f} ms = {mbit:.1f} Mbit/s "
          f"(route: {'in-place' if dispatch.use_inplace(CODE, B_INPLACE, 'cuda') else 'state-order'})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.library()
    tag = card_tag()
    print(f"[{tag}] build: {_build.build_seconds():.2f} s in nvcc, {time.perf_counter() - t0:.2f} s "
          f"to load; torch {torch.__version__} cuda {torch.version.cuda}")
    rng = np.random.default_rng(SEED)
    errs = phase_kernels(tag, rng)
    launches = phase_decode(tag, rng)
    rows = phase_timing(tag, rng)

    replaces = {
        "acs_update_tb": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py:227",
        "chainback_tb": "ka9q_viterbi_comparison_tpu/ops/pallas/kernels.py:361",
        "acs_update_inplace": "ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py:468",
        "chainback_inplace": "ka9q_viterbi_comparison_tpu/ops/pallas/inplace.py:630",
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": "ka9q_viterbi_comparison_tpu_torch/csrc/viterbi_small.cu",
         "replaces": replaces[name], "launches": launches[name], "max_abs_err": errs[name],
         **rows[name], "library_ms": None}
        for name in replaces]}
    print(json.dumps(line))
    print(tag)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
