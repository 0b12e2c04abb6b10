"""Measure the in-place pair's kernels on one GPU.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_inplace

Builds the kernels as the port does, holds the in-place ACS kernel and both
tracebacks against their plain versions at a few shapes, then times
``acs_update_inplace`` with CUDA events at K=7 (r=1/2 and r=1/4) and K=9 over
a range of batches, the block form (K=15) at three batches, and the
tracebacks.  Every line carries the card's name and power limit.  Needs a CUDA
device.  With ``--sass FILE`` it only builds and writes the machine code of
``csrc/viterbi_small.cu`` (``cuobjdump -sass``) and each kernel's registers
and spills (``cuobjdump -res-usage``) to ``FILE``.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import torch

from .. import (CodeSpec, VITERBI27, VITERBI29, VITERBI47, VITERBI615, soft8_spec,
                soft16_spec)
from ..ops.cuda import _build, inplace, kernels

SEED = 5


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
    m = torch.from_numpy(rng.integers(0, 50, size=(code.num_states, B)).astype(np.int32)).cuda()
    end = torch.from_numpy(rng.integers(0, code.num_states, size=(1, B)).astype(np.int32)).cuda()
    return sym, m, end


def compare(tag, code, numeric, B, T, t_real, t0, rng) -> bool:
    sym, m, end = inputs(code, numeric, B, T, rng)
    mk, dk = inplace.acs_update_inplace(code, numeric, m, sym, t_real, t0)
    mr, dr = inplace.acs_update_inplace_ref(code, numeric, m, sym, t_real, t0)
    nw = -(-t_real // 32)
    ok = [torch.equal(mk, mr), torch.equal(dk[:t_real], dr[:t_real]),
          torch.equal(inplace.chainback_inplace(code, dk, end, t_real, t0)[:nw],
                      inplace.chainback_inplace_ref(code, dr, end, t_real, t0)[:nw]),
          torch.equal(kernels.chainback_tb(code, dk, end, t_real)[:nw],
                      kernels.chainback_tb_ref(code, dr, end, t_real)[:nw])]
    torch.cuda.synchronize()
    print(f"[{tag}] {code.name} {numeric.name} B={B} t_real={t_real} t0={t0}: metrics "
          f"{ok[0]}, words {ok[1]}, chainback_inplace {ok[2]}, chainback_tb {ok[3]}", flush=True)
    return all(ok)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_inplace: no CUDA device available", file=sys.stderr)
        return 2
    tag = card_tag()
    rng = np.random.default_rng(SEED)
    _build.library()
    print(f"[{tag}] built in {_build.build_seconds():.1f} s of nvcc")

    if "--sass" in sys.argv:
        so = next(q for q in _build.library_paths() if "viterbi_small" in q.name)
        out = pathlib.Path(sys.argv[sys.argv.index("--sass") + 1])
        out.parent.mkdir(parents=True, exist_ok=True)
        cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
        with open(out, "w") as fh:
            subprocess.run([str(cuobjdump), "-res-usage", str(so)], stdout=fh, check=True)
            subprocess.run([str(cuobjdump), "-sass", str(so)], stdout=fh, check=True)
        print(f"[{tag}] wrote {out}")
        return 0

    ok = compare(tag, VITERBI27, soft8_spec(2), 513, 2000, 1999, 5, rng)
    ok &= compare(tag, VITERBI29, soft16_spec(2), 130, 700, 690, 3, rng)
    ok &= compare(tag, VITERBI47, soft8_spec(4), 64, 300, 300, 0, rng)
    ok &= compare(tag, CodeSpec("k5r2", 5, 2, (0o23, 0o35)), soft8_spec(2), 33, 100, 31, 2, rng)
    ok &= compare(tag, VITERBI615, soft8_spec(6), 9, 300, 293, 9, rng)
    if not ok:
        print("FAIL: a kernel disagrees with its plain version")
        return 1

    for code, T in ((VITERBI27, 8198), (VITERBI47, 8198), (VITERBI29, 4104)):
        numeric = soft8_spec(code.R)
        for B in (128, 512, 1024, 2048, 4096, 8192):
            sym, m, _ = inputs(code, numeric, B, T, rng)
            ms = timed_ms(lambda: inplace.acs_update_inplace(code, numeric, m, sym, T, 0), 5)
            print(f"[{tag}] acs_update_inplace {code.name} B={B} T={T}: {ms:.4f} ms = "
                  f"{1e6 * ms / T:.1f} ns a step", flush=True)
    for code, B, T in ((VITERBI615, 256, 2062), (VITERBI615, 128, 2062), (VITERBI615, 512, 2062)):
        numeric = soft8_spec(code.R)
        sym, m, _ = inputs(code, numeric, B, T, rng)
        ms = timed_ms(lambda: inplace.acs_update_inplace(code, numeric, m, sym, T, 0), 3)
        print(f"[{tag}] acs_update_inplace {code.name} B={B} T={T}: {ms:.4f} ms = "
              f"{1e6 * ms / T:.1f} ns a step")
    for code, B, T in ((VITERBI27, 512, 8198), (VITERBI27, 64, 8198), (VITERBI29, 512, 4104),
                       (VITERBI615, 256, 2062), (VITERBI615, 64, 2062)):
        numeric = soft8_spec(code.R)
        sym, m, end = inputs(code, numeric, B, T, rng)
        _, d = inplace.acs_update_inplace(code, numeric, m, sym, T, 0)
        rot = timed_ms(lambda: inplace.chainback_inplace(code, d, end, T, 0), 10)
        tb = timed_ms(lambda: kernels.chainback_tb(code, d, end, T), 10)
        print(f"[{tag}] K={code.K} B={B} T={T}: chainback_inplace {rot:.4f} ms = "
              f"{1e6 * rot / T:.1f} ns a step, chainback_tb {tb:.4f} ms = "
              f"{1e6 * tb / T:.1f} ns a step")
        del d
    return 0


if __name__ == "__main__":
    sys.exit(main())
