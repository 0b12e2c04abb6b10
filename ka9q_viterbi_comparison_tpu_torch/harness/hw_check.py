"""Hardware check of the port at the reference's frame sizes.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.hw_check [-o data/hw_check_torch.json]

The port's counterpart of ``tools/hw_check.py``.  On the card it records,
for every config of the reference's matrix (ref: src/main.cpp:363-419) at
its frame size (``configs.BENCH_FRAME_BYTES``) and the JAX tool's batch:

* the noiseless round-trip bit errors of the ``cuda`` backend (the kernels)
  and the ``torch`` backend (the portable path), which must be 0 (the
  reference's own invariant, ref: src/util.h:64-73);
* whether the two backends give the same bytes on AWGN symbols at 6 dB
  (``ops/channel.py``, noise from a ``torch.Generator`` on the device);
* the BER of the ``torch`` backend's decode against the transmitted data
  (recorded, not gated, as in the JAX tool);
* the route ``ops/cuda/dispatch.py`` takes for the code and batch and the
  kernel launches of the ``cuda`` decodes (``ops/cuda/_build.LAUNCHES``).

It then decodes the in-place envelope's canary, K=15 soft8 256-byte frames
at B=256 and B=512 on the ``cuda`` backend, with the route, the bit errors
and the two figures that decide the route on the card: one in-place block's
shared memory and the card's opt-in limit.  The JAX package leaves the
in-place route at B=512 (a TPU compiler fault); the port keeps it there on
purpose (``ROADMAP.md`` §3), so ``b512_expected_inplace`` is true.

The result, with the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them and the
seconds of every check, is written to ``data/hw_check_torch.json``; the exit
code is 1 unless every check passed.  The run is on the card and raises
without one; ``--device cpu`` runs both backends' plain versions, which
checks the plumbing and is no evidence of the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..configs import BENCH_FRAME_BYTES, STANDARD_CODES, VITERBI615, CodeSpec, soft8_spec
from ..models.decoder import BACKENDS, decode_frames, resolve_device
from ..ops.channel import awgn_symbols
from ..ops.cuda import _build, dispatch, inplace, large_k4
from ..ops.encoder import encode_frames
from ..utils.bits import count_bit_errors
from .ber_curve import card_name

__all__ = ["CHECK_BATCH", "EBN0_DB", "ENVELOPE_BATCHES", "route", "make_frames", "decode",
           "check_code", "code_ok", "envelope_row", "check_inplace_envelope", "envelope_ok",
           "all_ok", "main"]

# Small batches: a correctness check, not a throughput run; the frame size
# (what the CPU tests cannot reach) is the reference's.  The JAX tool's values.
CHECK_BATCH = {"viterbi27": 16, "viterbi47": 16, "viterbi29": 16,
               "viterbi49": 16, "viterbi615": 8, "viterbi224": 2}
EBN0_DB = 6.0  # decisions differ from the noiseless ones, but frames decode
ENVELOPE_BATCHES = (256, 512)


def route(code: CodeSpec, batch: int, device: torch.device) -> dict:
    """The route ``dispatch.acs_update`` takes for ``code`` at ``batch``:
    the in-place pair, the state-order pair (K <= 9) or the large-K kernels
    at a depth of 4 or 2 steps a launch."""
    inplace_route = dispatch.use_inplace(code, batch, device)
    small = dispatch.supports(code)
    depth = None
    if not inplace_route and not small:
        depth = 4 if large_k4.supports(code) else 2
    return {"use_inplace": inplace_route, "supports": small, "large_k_depth": depth}


def make_frames(code: CodeSpec, batch: int, n_bytes: int, rng: np.random.Generator,
                device: torch.device):
    """``(data [B, N] uint8, clean symbols, AWGN symbols)``, the symbols
    ``[B, T*R]`` int32 on ``device``.  The noise's generator is seeded from
    ``rng``, so a seed gives the same symbols on the same device."""
    numeric = soft8_spec(code.R)
    data = rng.integers(0, 256, size=(batch, n_bytes), dtype=np.uint8)
    clean = encode_frames(code, numeric, torch.from_numpy(data).to(device))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2**31)))
    noisy = awgn_symbols(code, numeric, data, EBN0_DB, gen, device)
    return data, clean, noisy


def decode(code: CodeSpec, symbols: torch.Tensor, n_bytes: int, backend: str) -> np.ndarray:
    """``decode_frames`` of soft8 symbols on their device, as numpy bytes."""
    return decode_frames(code, soft8_spec(code.R), symbols, n_bytes * 8, backend=backend,
                         device=symbols.device).cpu().numpy()


def _launched(before: dict[str, int]) -> dict[str, int]:
    """The kernel launches since ``before`` (a copy of ``_build.LAUNCHES``)."""
    return {k: n - before[k] for k, n in _build.LAUNCHES.items() if n != before[k]}


def code_ok(row: dict) -> bool:
    return (row["noiseless_bit_errors_cuda"] == 0 and row["noiseless_bit_errors_torch"] == 0
            and row["awgn_backend_bit_agreement"])


def check_code(code: CodeSpec, rng: np.random.Generator, n_bytes: int | None = None,
               batch: int | None = None, device: torch.device | str = "cuda") -> dict:
    """One config's row: both backends on the same noiseless and AWGN frames.
    ``n_bytes`` and ``batch`` default to the reference's frame size and the
    JAX tool's batch."""
    device = resolve_device(device)
    n_bytes = n_bytes or BENCH_FRAME_BYTES[code.name]
    B = batch or CHECK_BATCH[code.name]
    start = time.perf_counter()
    data, clean, noisy = make_frames(code, B, n_bytes, rng, device)
    out, seconds, launches = {}, {}, {}
    for backend in BACKENDS:
        before = dict(_build.LAUNCHES)
        t = time.perf_counter()
        out[backend] = [decode(code, s, n_bytes, backend) for s in (clean, noisy)]
        seconds[backend] = time.perf_counter() - t
        launches[backend] = _launched(before)
    row = {
        "name": code.name, "K": code.K, "R": code.R,
        "frame_bytes": n_bytes, "batch": B,
        "noiseless_bit_errors_cuda": count_bit_errors(out["cuda"][0], data),
        "noiseless_bit_errors_torch": count_bit_errors(out["torch"][0], data),
        "awgn_ebn0_db": EBN0_DB,
        "awgn_backend_bit_agreement": bool(np.array_equal(out["cuda"][1], out["torch"][1])),
        "awgn_ber_vs_transmitted": count_bit_errors(out["torch"][1], data) / float(B * n_bytes * 8),
        "route": route(code, B, device),
        "launches": launches,
        "decode_seconds": seconds,
    }
    row["ok"] = code_ok(row)
    row["seconds"] = time.perf_counter() - start
    return row


def envelope_row(rng: np.random.Generator, batch: int, n_bytes: int | None = None,
                 device: torch.device | str = "cuda") -> dict:
    """The canary at one batch: K=15 soft8 noiseless frames through the
    ``cuda`` backend, its route, bit errors, launches and seconds, and the
    shared-memory figures ``dispatch.fits_shared`` compares."""
    device = resolve_device(device)
    code = VITERBI615
    n_bytes = n_bytes or BENCH_FRAME_BYTES[code.name]
    data = rng.integers(0, 256, size=(batch, n_bytes), dtype=np.uint8)
    clean = encode_frames(code, soft8_spec(code.R), torch.from_numpy(data).to(device))
    before = dict(_build.LAUNCHES)
    t = time.perf_counter()
    out = decode(code, clean, n_bytes, "cuda")
    seconds = time.perf_counter() - t
    return {
        "batch": batch, "frame_bytes": n_bytes,
        "routed_inplace": dispatch.use_inplace(code, batch, device),
        "bit_errors": count_bit_errors(out, data),
        "smem_bytes": inplace.inplace_smem_bytes(code),
        "smem_optin_bytes": dispatch.shared_cap(device),
        "launches": _launched(before),
        "seconds": seconds,
    }


def envelope_ok(rows: dict) -> bool:
    """The JAX tool's rule: B=256 takes the in-place route and decodes
    exactly, B=512 decodes exactly (its route is recorded, not asserted)."""
    return (rows["b256"]["routed_inplace"] and rows["b256"]["bit_errors"] == 0
            and rows["b512"]["bit_errors"] == 0)


def check_inplace_envelope(rng: np.random.Generator, n_bytes: int | None = None,
                           device: torch.device | str = "cuda") -> dict:
    """The canary at ``ENVELOPE_BATCHES``, with ``ok``."""
    rows = {f"b{B}": envelope_row(rng, B, n_bytes, device) for B in ENVELOPE_BATCHES}
    rows["ok"] = envelope_ok(rows)
    # The port admits B=512 to the in-place route, where the JAX package
    # expects it rejected (ROADMAP.md section 3): recorded, not asserted.
    rows["b512_expected_inplace"] = True
    return rows


def all_ok(configs: list[dict], envelope: dict) -> bool:
    return all(r["ok"] for r in configs) and envelope["ok"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("hw_check", description=__doc__.splitlines()[0])
    p.add_argument("-o", "--output", default="data/hw_check_torch.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the plain versions, a check of the plumbing")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    start = time.perf_counter()
    if device.type == "cuda":
        _build.library()  # built before the checks' clocks start
    build_seconds = time.perf_counter() - start
    rng = np.random.default_rng(args.seed)
    rows = []
    for code in STANDARD_CODES:
        row = check_code(code, rng, device=device)
        print(f"{code.name}: ok={row['ok']} (noiseless errs {row['noiseless_bit_errors_cuda']}/"
              f"{row['noiseless_bit_errors_torch']}, agree={row['awgn_backend_bit_agreement']}, "
              f"route {row['route']}, launches {row['launches']['cuda']}, "
              f"{row['seconds']:.2f} s)", flush=True)
        rows.append(row)

    envelope = check_inplace_envelope(rng, device=device)
    print("inplace envelope: ok={ok} (b256 inplace={a[routed_inplace]} errs={a[bit_errors]} "
          "{a[seconds]:.3f} s; b512 inplace={b[routed_inplace]} errs={b[bit_errors]} "
          "{b[seconds]:.3f} s; smem {a[smem_bytes]} of {a[smem_optin_bytes]} B)".format(
              ok=envelope["ok"], a=envelope["b256"], b=envelope["b512"]), flush=True)

    result = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "card": card_name(device),
        "torch": torch.__version__,
        "seed": args.seed,
        "build_seconds": build_seconds,
        "seconds": time.perf_counter() - start,
        "all_ok": all_ok(rows, envelope),
        "configs": rows,
        "inplace_envelope": envelope,
    }
    with open(args.output, "w") as f:
        json.dump(result, f, indent=1)
    print(f"all_ok={result['all_ok']} -> {args.output} ({result['card']}, "
          f"{result['seconds']:.1f} s)")
    return 0 if result["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
