"""BER-vs-Eb/N0 curve CLI: the port's counterpart of ``tools/ber_curve.py``.

    python -m ka9q_viterbi_comparison_tpu_torch.harness.ber_curve --code viterbi27 \\
        --spec soft16 --ebn0 0 1 2 3 4 5 --frame-bytes 128 --batch 256 --min-errors 300 \\
        --max-bits 30000000 --json data/ber_torch_viterbi27.json \\
        --doc docs/ber_torch_viterbi27.md

Each point is ``harness.ber.measure_ber``: AWGN frames made on the device and
decoded by the port's ``decode_symbols``, on the card's kernels
(``--backend cuda``, the default) or the portable path (``--backend
torch``).  The run is on the card unless ``--device cpu`` is given, and
raises without one.  It prints the markdown table; ``--json`` writes the
points with the command, the card's name and power limit (as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them) and the
curve's seconds, and ``--doc`` writes ``render`` of that record, so every
doc is generated from its JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shlex
import subprocess
import sys
import time

import torch

from ..configs import STANDARD_CODES, hard8_spec, soft8_spec, soft16_spec
from ..models.decoder import resolve_device
from ..models.functional import decode_symbols
from .ber import BerPoint, measure_ber

__all__ = ["main", "render", "card_name", "point_record", "SPECS", "PROG"]

PROG = "python -m ka9q_viterbi_comparison_tpu_torch.harness.ber_curve"
SPECS = {"soft16": soft16_spec, "soft8": soft8_spec, "hard8": hard8_spec}


def card_name(device: torch.device | str) -> str:
    """The card's name and power limit as nvidia-smi prints them; ``"CPU"``
    for a run on the host."""
    if torch.device(device).type != "cuda":
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def point_record(pt: BerPoint, seconds: float) -> dict:
    """A point as ``tools/ber_curve.py`` writes it, with its seconds."""
    return dict(dataclasses.asdict(pt), ber=pt.ber, fer=pt.fer, ber_ci=pt.ber_ci(),
                uncoded_ber=pt.uncoded_ber, seconds=seconds)


def render(points: list[dict], code: str, spec: str, command: str, card: str,
           seconds: float) -> str:
    """The markdown doc of a curve record (``--json``'s object)."""
    head = f"""# AWGN performance — {code} ({spec}) on {card}

Coded BER and FER of {code} with {spec} inputs over an AWGN channel, generated
and decoded on the device by the PyTorch/CUDA port (`harness/ber.py`
`measure_ber`, frames from numpy's generator and noise from the device's,
both seeded), in {seconds:.1f} s on {card}:

    {command}

Each point decodes batches until it has `--min-errors` bit errors or
`--max-bits` bits.  The 95% column is a Wilson score interval on the bit-error
count; bit errors within a frame are correlated (an error event spans several
trellis steps), so it is anti-conservative at the margin, while frames are
independent and FER is frame errors over frames.  `uncoded` is BPSK
Q(sqrt(2 Eb/N0)) at the same Eb/N0.

| Eb/N0 (dB) | bits | bit errors | BER | 95% CI | uncoded | FER |
| --- | --- | --- | --- | --- | --- | --- |
"""
    rows = [f"| {p['ebn0_db']:g} | {p['bits']} | {p['errors']} | {p['ber']:.3e} "
            f"| [{p['ber_ci'][0]:.2e}, {p['ber_ci'][1]:.2e}] | {p['uncoded_ber']:.3e} "
            f"| {p['fer']:.3e} |\n" for p in points]
    return head + "".join(rows)


def main(argv: list[str] | None = None) -> dict:
    """Measure the curve, print its doc, write ``--json`` and ``--doc``;
    returns the record."""
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser("ber_curve")
    p.add_argument("--code", default="viterbi27", choices=[c.name for c in STANDARD_CODES])
    p.add_argument("--spec", default="soft16", choices=list(SPECS))
    p.add_argument("--ebn0", type=float, nargs="+", default=[0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
    p.add_argument("--frame-bytes", type=int, default=128)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--min-errors", type=int, default=100)
    p.add_argument("--max-bits", type=int, default=5_000_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"],
                   help="cuda: the card's kernels; torch: the portable path")
    p.add_argument("--json", default=None, help="also write the record here")
    p.add_argument("--doc", default=None, help="also write the markdown doc here")
    args = p.parse_args(argv)

    code = {c.name: c for c in STANDARD_CODES}[args.code]
    numeric = SPECS[args.spec](code.R)
    device = resolve_device(args.device)
    card = card_name(device)

    def decode(syms):
        return decode_symbols(code, numeric, syms, args.frame_bytes * 8, backend=args.backend,
                              device=device)

    points = []
    t_start = time.perf_counter()
    for ebn0 in args.ebn0:
        t0 = time.perf_counter()
        pt = measure_ber(code, numeric, ebn0, frame_bytes=args.frame_bytes, batch=args.batch,
                         min_errors=args.min_errors, max_bits=args.max_bits, seed=args.seed,
                         decode=decode, device=device)
        points.append(point_record(pt, time.perf_counter() - t0))
    record = {"code": code.name, "spec": args.spec,
              "command": " ".join([PROG] + [shlex.quote(a) for a in argv]), "card": card,
              "seconds": time.perf_counter() - t_start, "points": points}
    doc = render(**record)
    print(doc, end="")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f)
    if args.doc:
        with open(args.doc, "w") as f:
            f.write(doc)
    return record


if __name__ == "__main__":
    main()
