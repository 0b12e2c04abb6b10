"""Measure the state-order K <= 9 ACS kernels on one GPU.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_tb

Builds the kernels as the port does, holds ``acs_update_tb`` and
``acs_update_tb2`` against their plain versions at small shapes (K=3..9,
codes with and without the complement form, batches of 1, 33 and 130, odd
``t_real``), then times both with CUDA events at the reference's frame sizes
(K=7 soft8 1024-byte frames, K=9 soft16 512-byte frames) over batches 1-1024,
each beside ``acs_update_inplace`` on the same frames: the in-place sweep is
the least that a state-order kernel built on it (its words permuted to the
canonical packing after the sweep) could take.  With ``--paths`` it times
instead the paths these kernels carry: the update phase of
``ViterbiDecoder(backend="cuda")`` at K=7, B=1 and B=64 (the state-order
route), and of ``dispatch.phase_fns`` with the in-place route off
(``KA9Q_TORCH_INPLACE=0``) at K=7 and K=9, B=512 and 1024.  With
``--near-limit`` it holds the large-K updates against their plain versions
from entry metrics within 64 of the int32 limit, through every route of
their launch plans, and prints which agree.  Every line carries the card's
name and power limit.  Needs a CUDA device.

It imports the package by absolute name, so the same file times another
checkout of the port: ``cd OTHER && PYTHONPATH=. python3 PATH/TO/probe_tb.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from ka9q_viterbi_comparison_tpu_torch import (CodeSpec, VITERBI27, VITERBI29, VITERBI47,
                                               VITERBI49, VITERBI615, ViterbiDecoder, soft8_spec,
                                               soft16_spec)
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import (_build, dispatch, inplace, kernels,
                                                        kernels2, large_k, large_k2, large_k4)

SEED = 7


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
    sym = torch.from_numpy(rng.integers(numeric.soft_low, numeric.soft_high + 1,
                                        size=(T, code.R, B)).astype(np.int32)).cuda()
    m = torch.from_numpy(rng.integers(0, 60, size=(code.num_states, B)).astype(np.int32)).cuda()
    return sym, m


def compare(tag, code, numeric, B, T, t_real, rng) -> bool:
    sym, m = inputs(code, numeric, B, T, rng)
    ok = True
    for name, fn, ref in (("acs_update_tb", kernels.acs_update_tb, kernels.acs_update_tb_ref),
                          ("acs_update_tb2", kernels2.acs_update_tb2,
                           kernels2.acs_update_tb2_ref)):
        if name == "acs_update_tb2" and code.K < 3:
            continue
        mk, dk = fn(code, numeric, m, sym, t_real)
        mr, dr = ref(code, numeric, m, sym, t_real)
        torch.cuda.synchronize()
        same = torch.equal(mk, mr) and torch.equal(dk[:t_real], dr[:t_real])
        print(f"[{tag}] {name} {code.name} {numeric.name} B={B} t_real={t_real}: "
              f"{'identical' if same else 'DIFFERS'}", flush=True)
        ok &= same
    return ok


def update_ms(fn, reps: int = 6) -> float:
    """Median of CUDA-event times of ``fn`` after one warm-up call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def paths(tag, rng) -> int:
    code, numeric = VITERBI27, soft8_spec(2)
    for B in (1, 64):
        sym = torch.from_numpy(rng.integers(-3, 4, size=(B, 8198, 2)).astype(np.int32)).cuda()
        dec = ViterbiDecoder(code, numeric, B, "cuda")

        def update():
            dec.reset()
            dec.update(sym)
        print(f"[{tag}] ViterbiDecoder K=7 soft8 B={B} T=8198 update phase "
              f"{update_ms(update):.4f} ms", flush=True)
    saved = os.environ.get("KA9Q_TORCH_INPLACE")
    os.environ["KA9Q_TORCH_INPLACE"] = "0"
    try:
        for code, n_bytes in ((VITERBI27, 1024), (VITERBI29, 512)):
            numeric = soft8_spec(code.R)
            T = code.transmit_bits(n_bytes)
            for B in (512, 1024):
                sym = torch.from_numpy(rng.integers(-3, 4, size=(B, T, code.R))
                                       .astype(np.int32)).cuda()
                init_fn, update_fn, _, prepare_fn = dispatch.phase_fns(code, numeric,
                                                                       n_bytes * 8, B)[:4]
                prepared, m = prepare_fn(sym), init_fn(B)
                ms = timed_ms(lambda: update_fn(m, prepared), 10)
                print(f"[{tag}] phase_fns K={code.K} soft8 B={B} T={T} (in-place off) update "
                      f"phase {ms:.4f} ms", flush=True)
    finally:
        if saved is None:
            del os.environ["KA9Q_TORCH_INPLACE"]
        else:
            os.environ["KA9Q_TORCH_INPLACE"] = saved
    return 0


def near_limit_cases(rng):
    """Inputs of the large-K updates from entry metrics within 64 of the
    int32 limit (a step's penalties carry most of them past it), their
    minimum far from zero, through every route of the launch plans: the pair
    kernel on chip (Cassini) and streaming (a K=10 R=7 code, whose blocks are
    too small for the on-chip form), odd and even; the depth-4 forms' 7-step
    launch, quads and a remainder (on chip at K=12; at K=18, where the frame
    streams, with the remainder's entry shift from the last quad launch), no
    remainder, the fields forms' one-launch leads and a lead of quads and
    pairs; ``acs_update_large`` in its three forms (on chip, octets with a
    7-step launch or a step after the quads, streaming).  Yields ``(module,
    name, args)`` on the card, four frames each."""
    k12 = CodeSpec("k12r2", 12, 2, (0o6731, 0o5247))
    k10 = CodeSpec("k10r7", 10, 7, (0o1167, 0o1546, 0o1353, 0o1731, 0o1215, 0o1473, 0o1621))
    k18 = CodeSpec("k18r2", 18, 2, (0o647153, 0o526715))
    for mod, name, code, T, lead in (
            (large_k2, "acs_update_large2", VITERBI615, 9, ()),
            (large_k2, "acs_update_large2", VITERBI615, 10, ()),
            (large_k2, "acs_update_large2", k10, 9, ()), (large_k2, "acs_update_large2", k10, 10, ()),
            (large_k4, "acs_update_large4", k12, 11, ()), (large_k4, "acs_update_large4", k12, 13, ()),
            (large_k4, "acs_update_large4", k12, 16, ()),
            (large_k4, "acs_update_large4_fields", k12, 11, (3,)),
            (large_k4, "acs_update_large4_fields", k12, 13, (5,)),
            (large_k4, "acs_update_large4_fields8", k12, 15, (7,)),
            (large_k4, "acs_update_large4_fields8", k12, 13, (5,)),
            (large_k4, "acs_update_large4", k18, 9, ()), (large_k4, "acs_update_large4", k18, 10, ()),
            (large_k, "acs_update_large", VITERBI615, 9, ()),
            (large_k, "acs_update_large", k18, 7, ()), (large_k, "acs_update_large", k18, 9, ()),
            (large_k, "acs_update_large", k10, 9, ())):
        sym = torch.from_numpy(rng.integers(-3, 4, size=(4, T, code.R)).astype(np.int32)).cuda()
        m = torch.from_numpy(rng.integers(2**31 - 64, 2**31 - 1, size=(4, code.num_states))
                             .astype(np.int32)).cuda()
        yield mod, name, (code, soft8_spec(code.R), m, sym, *lead)


def near_limit(tag, rng) -> int:
    differ = n = 0
    for mod, name, args in near_limit_cases(rng):
        got = getattr(mod, name)(*args)
        want = getattr(mod, name + "_ref")(*args)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        differ += not same
        n += 1
        print(f"[{tag}] {name} {args[0].name} T={args[3].shape[1]} lead={args[4:]} from entry "
              f"metrics near the int32 limit: {'identical' if same else 'DIFFERS'} to its plain "
              f"version", flush=True)
    print(f"[{tag}] {differ} of {n} cases differ")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tb: no CUDA device available", file=sys.stderr)
        return 2
    tag = card_tag()
    rng = np.random.default_rng(SEED)
    _build.library()
    print(f"[{tag}] built in {_build.build_seconds():.1f} s of nvcc", flush=True)
    if "--paths" in sys.argv:
        return paths(tag, rng)
    if "--near-limit" in sys.argv:
        return near_limit(tag, rng)

    ok = True
    for code, numeric, B, T, t_real in (
            (CodeSpec("k3r2", 3, 2, (0o7, 0o5)), soft8_spec(2), 33, 100, 99),
            (CodeSpec("k5r2", 5, 2, (0o23, 0o35)), soft8_spec(2), 1, 70, 31),
            (CodeSpec("k6r3", 6, 3, (0o53, 0o75, 0o47)), soft8_spec(3), 130, 70, 69),
            (VITERBI27, soft8_spec(2), 130, 300, 299), (VITERBI47, soft8_spec(4), 33, 200, 200),
            (VITERBI29, soft16_spec(2), 1, 300, 257), (VITERBI49, soft8_spec(4), 130, 100, 77),
            (CodeSpec("k7oneend", 7, 2, (0o155, 0o056)), soft8_spec(2), 33, 150, 149),
            (CodeSpec("k9oneend", 9, 3, (0o557, 0o256, 0o711)), soft8_spec(3), 33, 150, 150)):
        ok &= compare(tag, code, numeric, B, T, t_real, rng)
    if not ok:
        print("FAIL: a kernel disagrees with its plain version")
        return 1

    for code, numeric, T in ((VITERBI27, soft8_spec(2), 8198), (VITERBI29, soft16_spec(2), 4104)):
        for B in (1, 64, 512, 1024):
            sym, m = inputs(code, numeric, B, T, rng)
            iters = 10
            tb = timed_ms(lambda: kernels.acs_update_tb(code, numeric, m, sym, T), iters)
            tb2 = timed_ms(lambda: kernels2.acs_update_tb2(code, numeric, m, sym, T), iters)
            ip = timed_ms(lambda: inplace.acs_update_inplace(code, numeric, m, sym, T, 0), iters)
            print(f"[{tag}] K={code.K} {numeric.name} B={B} T={T}: acs_update_tb {tb:.4f} ms = "
                  f"{1e6 * tb / T:.1f} ns a step; acs_update_tb2 {tb2:.4f} ms = "
                  f"{1e6 * tb2 / T:.1f} ns a step; acs_update_inplace {ip:.4f} ms = "
                  f"{1e6 * ip / T:.1f} ns a step", flush=True)
            del sym, m
    return 0


if __name__ == "__main__":
    sys.exit(main())
