"""Measure the u8 replicas' kernel on one GPU.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_u8 [--sass FILE]

Builds the kernels as the port does and prints the registers and spills of
each instance of ``u8_warp_kernel`` (``nvcc -Xptxas -v`` on
``csrc/viterbi_u8.cu``); then times ``quantized_update`` and
``spiral_update`` alone with CUDA events on AWGN symbols (ka9q
offset-binary, 3 dB, 1024-byte frames) at K=7 and K=9 over batches 64, 512
and 2048, SPIRAL also with its renormalisation threshold out of reach (255:
the per-step check runs and never fires).  ``chip_smoke.py`` holds the
kernel against its plain version and times the decodes.  With ``--sass
FILE`` it also writes the machine code of ``csrc/viterbi_u8.cu``
(``cuobjdump -sass``) to ``FILE`` and prints each kernel instance's
instruction count by opcode.  Every line carries the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import collections
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from ka9q_viterbi_comparison_tpu_torch import VITERBI27, VITERBI29, ka9q_offset_binary_spec
from ka9q_viterbi_comparison_tpu_torch.harness.probe_tb import card_tag, timed_ms
from ka9q_viterbi_comparison_tpu_torch.ops import channel, quantized
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build

SEED = 13
FRAME_BYTES, EBN0 = 1024, 3.0


def registers(tag) -> None:
    """Registers and spills of each kernel instance, from ptxas."""
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "/dev/null",
                          str(_build.CSRC / "viterbi_u8.cu")], capture_output=True, text=True)
    name, spill = None, ""
    for line in out.stderr.splitlines():
        hit = re.search(r"u8_warp_kernelILi(\d+)ELb([01])E", line)
        if "Compiling entry function" in line and hit:
            name = f"K={hit.group(1)} {'spiral' if hit.group(2) == '1' else 'ka9q'}"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"[{tag}] u8_warp_kernel {name}: {regs} registers; {spill}")
            name = None


def sass(tag, path: pathlib.Path) -> None:
    """The library's machine code into ``path``; per kernel instance, its
    instructions by opcode (the static count: the step loop's unrolled
    groups and its tail, the set-up and the stage refill)."""
    so = next(p for p in _build.library_paths() if p.name.startswith("libviterbi_u8_"))
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        hit = re.search(r"u8_warp_kernelILi(\d+)ELb([01])E", fn)
        ops = collections.Counter(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", fn))
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(12))
        print(f"[{tag}] u8_warp_kernel K={hit.group(1)} {'spiral' if hit.group(2) == '1' else 'ka9q'}: "
              f"{sum(ops.values())} instructions ({top})")


def awgn(code, B, gen) -> torch.Tensor:
    """``[B, 2T]`` uint8 ka9q offset-binary symbols of random frames at EBN0."""
    data = np.random.default_rng(SEED + B).integers(0, 256, (B, FRAME_BYTES), dtype=np.uint8)
    return channel.awgn_symbols(code, ka9q_offset_binary_spec(), data, EBN0, gen).to(torch.uint8)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_u8: no CUDA device available", file=sys.stderr)
        return 2
    tag = card_tag()
    _build.library()
    print(f"[{tag}] built in {_build.build_seconds():.1f} s of nvcc", flush=True)
    registers(tag)
    if "--sass" in sys.argv:
        sass(tag, pathlib.Path(sys.argv[sys.argv.index("--sass") + 1]))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for code in (VITERBI27, VITERBI29):
        T = code.transmit_bits(FRAME_BYTES)
        for B in (64, 512, 2048):
            sym = awgn(code, B, gen)
            sym3 = sym.reshape(B, T, 2)
            m0 = quantized.init_metrics_u8(code, B)
            ka9q = timed_ms(lambda: quantized.quantized_update(code, m0, sym3), 20)
            spiral = timed_ms(lambda: quantized.spiral_update(code, m0, sym3), 20)
            saved, quantized.SPIRAL_RENORM_THRESHOLD = quantized.SPIRAL_RENORM_THRESHOLD, 255
            try:
                quiet = timed_ms(lambda: quantized.spiral_update(code, m0, sym3), 20)
            finally:
                quantized.SPIRAL_RENORM_THRESHOLD = saved
            print(f"[{tag}] {code.name} B={B} T={T}: ka9q {ka9q:.4f} ms = {1e6 * ka9q / T:.1f} ns "
                  f"a step; spiral {spiral:.4f} ms = {1e6 * spiral / T:.1f} ns; spiral with the "
                  f"threshold out of reach {quiet:.4f} ms = {1e6 * quiet / T:.1f} ns", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
