"""Measure the large-K kernels on one GPU.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_large [--sass FILE] [--trace DIR]
    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_large --plan

Builds the kernels as the port does and writes each kernel's registers,
shared memory and spills (``cuobjdump -res-usage`` of the two large-K
libraries; with ``--sass FILE`` also their machine code, to ``FILE``).  Then
holds the on-chip pair kernel and the octet kernel's three forms against
their plain versions at the shapes it times, and times with CUDA events:
``acs_update_large2`` at Cassini soft8 (T = 2062) over batches 1-256; the
on-chip pair kernel at one, two and four blocks a frame (each that fits) for
r=1/6 codes at K=13-16 (Cassini: 15), B=8, 64 and 128; the octet forms at ICE
soft8 B=8 T=87 beside their metric-traffic floor, and the streaming pair at
ICE.  With ``--trace DIR``, three ``_fields8`` calls at
that shape run under ``harness.profiling.device_trace`` (a Chrome trace in
``DIR``), and it prints the device time by kernel and the device's idle
share over their span.  With ``--plan`` it does only this: ``acs_update_large``
in the form ``large_k.plan`` picks against the route it replaces (one launch
of the step kernel a step after a frame-minimum pass,
``large_k.launch_large(..., steps=1, nl=T)``), both held against the plain
version and timed in turns on the same inputs, at Cassini soft8 B=64 T=1031
and T=1 and ICE soft8 B=8 T=87 and T=1, with each call's kernel launches from
a profiler trace and the bound; then the step kernel's pass alone at ICE
B=8 T=1.  Every line carries the card's name and power limit.  Needs a CUDA
device.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from .. import VITERBI224, VITERBI615, CodeSpec, soft8_spec
from ..ops.cuda import _build, large_k, large_k2, large_k4

SEED = 7
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.73e12  # 132 SMs x 64 INT32 lanes x 1.98 GHz


def card_tag() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(code, numeric, B, T, rng):
    sym = torch.from_numpy(rng.integers(-3, 4, size=(B, T, code.R)).astype(np.int32)).cuda()
    m = torch.full((B, code.num_states), numeric.initial_margin, dtype=torch.int32, device="cuda")
    m[:, 0] = 0
    return m, sym


def res_usage(tag, sass):
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    for so in _build.library_paths():
        if "large" not in so.name:
            continue
        out = subprocess.run([str(cuobjdump), "-res-usage", str(so)], capture_output=True,
                             text=True, check=True).stdout
        fn = None
        for line in out.splitlines():
            if line.strip().startswith("Function"):
                fn = line.strip().split()[1].rstrip(":")
            elif "REG:" in line and fn:
                print(f"[{tag}] {so.name.split('_')[0]} {fn}: {line.strip()}")
        if sass is not None:
            with open(sass, "a") as fh:
                subprocess.run([str(cuobjdump), "-sass", str(so)], stdout=fh, check=True)


def cluster_sizes(tag, rng) -> bool:
    """The on-chip pair kernel at 1, 2 and 4 blocks a frame, each the
    launcher takes (a block holds at most ``large_k2.CHIP_STATES`` states,
    and no fewer quads than a pair has table entries), for r=1/6 codes at
    K=13-16 (Cassini: 15), soft8, T = 2062, B = 8, 64 and 128; held against
    the plain version at B=8.  Returns whether all were equal."""
    ok = True
    s8, T = soft8_spec(6), 2062
    for K in (13, 14, 15, 16):
        code = VITERBI615 if K == 15 else CodeSpec(
            f"k{K}r6", K, 6, tuple((1 << (K - 1)) | int(rng.integers(0, 1 << (K - 1))) | 1
                                   for _ in range(6)))
        _, rn = large_k2.renorm_schedule(code, s8, T)
        for B in (8, 64, 128):
            m, sym = inputs(code, s8, B, T, rng)
            want = large_k2.acs_update_large2_ref(code, s8, m, sym) if B == 8 else None
            for cl in (1, 2, 4):
                if not 2 << code.R <= code.num_states // cl // 4 <= large_k2.CHIP_STATES // 4:
                    continue

                def call():
                    words, strides = large_k2.words_buffer(B, T, code.decision_words, False,
                                                           m.device)
                    off = torch.zeros((B,), dtype=torch.int32, device=m.device)
                    mo = large_k2.launch_chip(code, s8, m, sym, words, off, strides, 0, T, rn, cl)
                    return mo, words, off

                same = want is None or all(torch.equal(a, b) for a, b in zip(call(), want))
                ok &= same
                ms = timed_ms(call, 5)
                pick = " (chip_blocks)" if cl == large_k2.chip_blocks(code, B) else ""
                print(f"[{tag}] on-chip pair K={K} r=1/6 soft8 B={B} T={T}, {cl} blocks a "
                      f"frame{pick}: {ms:.4f} ms = {1e3 * ms / (T // 2):.3f} us a pair"
                      + ("" if want is None else f" (equal to the plain version {same})"),
                      flush=True)
            del m, sym, want
            torch.cuda.empty_cache()
    return ok


def acs_bound(code, B, T, words=True):
    """Least time of ``T`` ACS steps (ms, and by what): each input and
    output once (symbols, metrics in and out, words), or the int32
    operations (the 2^R penalty sums of R terms a step, 6 a state and
    step), whichever is longer."""
    S, W, R = code.num_states, code.decision_words, code.R
    t_bytes = 4 * B * (T * R + 2 * S + (T * W if words else 0)) / HBM_BYTES_PER_S * 1e3
    t_ops = B * T * ((1 << R) * R + 6 * S) / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_launches(fn) -> dict[str, int]:
    """The kernel launches of one call of ``fn`` in a profiler trace:
    kernel name -> launches (empty where the profiler records no device
    time)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            hit = re.search(r"(\w+)(?:<[^()]*>)?\(", e.key)
            name = hit.group(1) if hit else e.key.strip()[:40]
            counts[name] = counts.get(name, 0) + e.count
    return counts


def plan_mode(tag, rng) -> bool:
    """``acs_update_large`` in its plan's form against the one-launch-a-step
    route, in turns (route, plan, plan, route) on the same inputs.  Returns
    whether every result equalled the plain version."""
    ok = True
    for code, B, T in ((VITERBI615, 64, 1031), (VITERBI615, 64, 1), (VITERBI224, 8, 87),
                       (VITERBI224, 8, 1)):
        numeric = soft8_spec(code.R)
        m, sym = inputs(code, numeric, B, T, rng)
        W = code.decision_words

        def old():
            words = torch.empty((B, T, W), dtype=torch.int32, device=m.device)
            off = torch.zeros((B,), dtype=torch.int32, device=m.device)
            mo = large_k.launch_large("acs_update_large", 1, code, numeric, m, sym, words, off,
                                      (T * W, W), 0, T)
            return mo, words, off

        def new():
            return large_k.acs_update_large(code, numeric, m, sym)

        want = large_k.acs_update_large_ref(code, numeric, m, sym)
        same = [all(torch.equal(a, b) for a, b in zip(fn(), want)) for fn in (old, new)]
        ok &= all(same)
        del want
        iters = 5 if T > 1 else 50
        times = {"route": [], "plan": []}
        for name in ("route", "plan", "plan", "route"):
            times[name].append(timed_ms(old if name == "route" else new, iters))
        p = large_k.plan(code, B, T)
        bnd = acs_bound(code, B, T)
        for name, fn in (("one launch a step", old), (f"plan ({p.form})", new)):
            counts = kernel_launches(fn)
            ms = times["route" if fn is old else "plan"]
            print(f"[{tag}] acs_update_large {code.name} soft8 B={B} T={T}, {name}: "
                  f"{ms[0]:.4f} / {ms[1]:.4f} ms, {sum(counts.values())} kernel launches "
                  f"(device trace: {counts}), equal to the plain version "
                  f"{same[0] if fn is old else same[1]}; bound {bnd[0]:.5f} ms ({bnd[1]}), "
                  f"{100 * bnd[0] / min(ms):.1f}% of bound; plan: {p.launches} launches, "
                  f"segments {p.segments}", flush=True)
        del m, sym
        torch.cuda.empty_cache()
    # The step kernel's pass alone at ICE B=8 T=1 (the entry shift not taken).
    code, numeric, B = VITERBI224, soft8_spec(2), 8
    m, sym = inputs(code, numeric, B, 1, rng)
    W = code.decision_words
    words = torch.empty((B, 1, W), dtype=torch.int32, device=m.device)
    off = torch.zeros((B,), dtype=torch.int32, device=m.device)
    ms = timed_ms(lambda: large_k.launch_large("acs_update_large", 1, code, numeric, m, sym, words,
                                               off, (W, W), 0, 1, shifts=False), 50)
    bnd = acs_bound(code, B, 1)
    print(f"[{tag}] acs_large_step_kernel ice B={B} T=1, the pass alone: {ms:.4f} ms, bound "
          f"{bnd[0]:.5f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound", flush=True)
    return ok


def trace(tag, log_dir, code, numeric, m, sym):
    """Three ``_fields8`` calls under the profiler: device time by kernel,
    and the idle share of the device over the span CUDA events measure."""
    from .profiling import device_trace
    fn = large_k4.acs_update_large4_fields8
    fn(code, numeric, m, sym, 7)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with device_trace(log_dir) as prof:
        start.record()
        for _ in range(3):
            fn(code, numeric, m, sym, 7)
        end.record()
        end.synchronize()
    span = start.elapsed_time(end) * 1e3  # us
    busy = 0.0
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            busy += dev
            rows.append((dev, e.count, e.key))
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        print(f"[{tag}] trace: {dev:.1f} us device time in {count} launches of {key[:90]}")
    print(f"[{tag}] trace: three acs_update_large4_fields8 calls, span {span:.1f} us, device busy "
          f"{busy:.1f} us, idle share {max(0.0, 1 - busy / span):.4f}; trace in {log_dir}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_large: no CUDA device available", file=sys.stderr)
        return 2
    tag = card_tag()
    rng = np.random.default_rng(SEED)
    _build.library()
    print(f"[{tag}] built in {_build.build_seconds():.1f} s of nvcc", flush=True)
    sass = sys.argv[sys.argv.index("--sass") + 1] if "--sass" in sys.argv else None
    if sass is not None:
        pathlib.Path(sass).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(sass).write_text("")
    if "--plan" in sys.argv:
        if not plan_mode(tag, rng):
            print("FAIL: a kernel disagrees with its plain version")
            return 1
        return 0
    res_usage(tag, sass)
    ok = True

    cas, s8 = VITERBI615, soft8_spec(6)
    T = cas.transmit_bits(256)
    for B in (1, 8, 64, 128, 256):
        m, sym = inputs(cas, s8, B, T, rng)
        if B in (1, 64):
            got = large_k2.acs_update_large2(cas, s8, m, sym)
            want = large_k2.acs_update_large2_ref(cas, s8, m, sym)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= same
            print(f"[{tag}] acs_update_large2 cassini B={B}: equal to the plain version {same}")
        ms = timed_ms(lambda: large_k2.acs_update_large2(cas, s8, m, sym), 10)
        print(f"[{tag}] acs_update_large2 cassini soft8 B={B} T={T} ({large_k2.chip_blocks(cas, B)} "
              f"blocks a frame): {ms:.4f} ms = {1e3 * ms / (T // 2):.3f} us a pair", flush=True)
    del m, sym
    torch.cuda.empty_cache()
    ok &= cluster_sizes(tag, rng)

    ice = VITERBI224
    s8 = soft8_spec(2)
    B, T = 8, ice.transmit_bits(8)
    m, sym = inputs(ice, s8, B, T, rng)
    traffic = 2 * B * ice.num_states * 4
    floor = traffic / HBM_BYTES_PER_S * 1e3
    for name, lead in (("acs_update_large4", None), ("acs_update_large4_fields", 3),
                       ("acs_update_large4_fields8", 7)):
        extra = () if lead is None else (lead,)
        fn = getattr(large_k4, name)
        got = fn(ice, s8, m, sym, *extra)
        want = getattr(large_k4, name + "_ref")(ice, s8, m, sym, *extra)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        ok &= same
        del got, want
        ms = timed_ms(lambda: fn(ice, s8, m, sym, *extra), 5)
        rest = sym[:, (lead or 0):].contiguous()
        nq = rest.shape[1] // 4
        body = rest[:, :4 * nq].contiguous()
        q_ms = timed_ms(lambda: fn(ice, s8, m, body, *(() if lead is None else (0,))), 5)
        passes = nq // 2 + nq % 2  # the launch plan's; chip_smoke.py counts them in a trace
        print(f"[{tag}] {name} ice B={B} T={T}: {ms:.4f} ms (equal {same}); its {nq} quads alone "
              f"{q_ms:.4f} ms in {passes} planned passes = {1e3 * q_ms / passes:.1f} us a pass; floor "
              f"{floor * 1e3:.1f} us a pass ({traffic / 1e6:.1f} MB at 3.35 TB/s)", flush=True)
        torch.cuda.empty_cache()
    ms = timed_ms(lambda: large_k2.acs_update_large2(ice, s8, m, sym), 3)
    print(f"[{tag}] acs_update_large2 ice B={B} T={T} (streaming): {ms:.4f} ms = "
          f"{1e3 * ms / (T // 2):.2f} us a pair")
    if "--trace" in sys.argv:
        trace(tag, sys.argv[sys.argv.index("--trace") + 1], ice, s8, m, sym)
    if not ok:
        print("FAIL: a kernel disagrees with its plain version")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
