"""Measure the staged traceback's segments (K <= 9) on one GPU.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_segments [--out FILE]

Times the walk alone (a CUDA graph of 50 calls, timed with CUDA events) at
the benchmark's shapes, on 3 dB words of the card's own ACS and on random
words, each call held bit-equal to the plain walk (``kernels.walk_ref``):

* K=7, B=512, T=8198: the decoder's data bytes from state 0
  (``chainback_inplace``, the frame cell's walk) and the words of both
  tracebacks;
* K=7, B=512, T=8248: bits from the argmin of the metrics (the stream
  cell's release walk over its window);
* K=9, B=512, T=4104: the data bytes.

Then it counts the segments walked again (``kernels.rewalk_stats``) in 3 dB
traffic like the K=7 cells': ``ViterbiDecoder`` on 1024-byte frames and
``StreamingDecoder`` on 8192-step pushes, B=512.  A tree without
``walk_plan`` (before the segments) is timed the same way and counts
nothing.  Every line names the
card and its power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import VITERBI27, VITERBI29, StreamingDecoder, ViterbiDecoder, soft8_spec
from ..ops import acs
from ..ops.channel import awgn_symbols
from ..ops.cuda import _build, inplace, kernels
from .probe_walk import card_tag, graph_ms

SEED = 23
B = 512
ITERS = 50


def stats() -> dict | None:
    return kernels.rewalk_stats() if hasattr(kernels, "rewalk_stats") else None


def share(before: dict | None, after: dict | None) -> dict | None:
    """Segments launched and walked again between two readings."""
    if before is None:
        return None
    seg = after["segments"] - before["segments"]
    again = after["rewalked"] - before["rewalked"]
    return {"segments": seg, "rewalked": again, "share": again / max(seg, 1)}


def noisy_inputs(code, T: int, g: torch.Generator):
    """``(position-packed words, state-order words [Tp, W, B], exit metrics
    [S, B] in position space)`` of B frames of at least T - K + 1 random
    bits (whole bytes) at 3 dB, Tp >= T steps."""
    numeric = soft8_spec(code.R)
    nbytes = -(-(T - code.K + 1) // 8)
    data = torch.randint(0, 256, (B, nbytes), generator=g, device="cuda", dtype=torch.uint8)
    sym = awgn_symbols(code, numeric, data, 3.0, generator=g, device="cuda")
    sym = sym.reshape(B, -1, code.R).permute(1, 2, 0)
    m0 = acs.init_metrics(code, numeric, B, device="cuda").T.contiguous()
    m_pos, dec_pos = inplace.acs_update_inplace(code, numeric, m0, sym, sym.shape[0])
    _, dec_tb = kernels.acs_update_tb(code, numeric, m0, sym, sym.shape[0])
    return dec_pos, dec_tb, m_pos


def walks(code, T: int, dec_pos, dec_tb, m_pos) -> list:
    """(name, words, rotated, endstate, form, keywords) of the walks timed."""
    K = code.K
    lo, hi = K - 1, K - 1 + (T - K + 1) // 8 * 8
    phase = dec_pos.shape[0] % (K - 1)  # the exit metrics' rotation
    out = [("inplace bytes from 0", dec_pos, True, 0, "bytes", dict(lo=lo, hi=hi))]
    if K == 7:
        out += [("inplace words from 0", dec_pos, True, 0, "words", {}),
                ("tb words from 0", dec_tb, False, 0, "words", {}),
                ("inplace bits from the argmin", dec_pos, True, None, "bits",
                 dict(lo=56, hi=T, metrics=m_pos, metrics_phase=phase))]
    return out


def time_walks(code, T: int, g: torch.Generator, tag: str, words: str) -> list:
    dec_pos, dec_tb, m_pos = noisy_inputs(code, T, g)
    if words == "random":
        dec_pos = torch.randint(-2**31, 2**31, dec_pos.shape, generator=g, device="cuda",
                                dtype=torch.int64).to(torch.int32)
        dec_tb = dec_pos
    rows = []
    for name, dec, rotated, end, form, kw in walks(code, T, dec_pos, dec_tb, m_pos):
        fn = ((lambda d=dec, e=end, f=form, k=kw: inplace.chainback_inplace(code, d, e, T, 0, f,
                                                                           **k))
              if rotated else
              (lambda d=dec, e=end, f=form, k=kw: kernels.chainback_tb(code, d, e, T, f, **k)))
        before = stats()
        got = fn()
        counted = share(before, stats())
        want = kernels.walk_ref(code, dec, end, T, rotated, 0, form, **kw)
        errs = int((got != want).sum())
        ms = graph_ms(fn, ITERS)
        row = {"card": tag, "K": code.K, "B": B, "T": T, "walk": name, "words": words,
               "plan": kernels.walk_plan(code.K, B, T) if hasattr(kernels, "walk_plan") else None,
               "ms": round(ms, 5), "errors": errs,
               "rewalks": counted}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def traffic(tag: str, g: torch.Generator) -> list:
    """The segments walked again in 3 dB frames and stream pushes."""
    code, numeric = VITERBI27, soft8_spec(2)
    rows = []
    dec = ViterbiDecoder(code, numeric, batch=B, backend="cuda", device="cuda")
    before = stats()
    errors = 0
    for _ in range(8):
        data = torch.randint(0, 256, (B, 1024), generator=g, device="cuda", dtype=torch.uint8)
        dec.reset()
        dec.update(awgn_symbols(code, numeric, data, 3.0, generator=g, device="cuda"))
        errors += int((dec.chainback(8 * 1024) != data).sum())
    rows.append({"card": tag, "traffic": "ViterbiDecoder 3 dB, 1024-byte frames", "calls": 8,
                 "byte_errors": errors, "rewalks": share(before, stats())})
    stream = StreamingDecoder(code, numeric, batch=B, backend="cuda", device="cuda")
    data = torch.randint(0, 256, (B, 4 * 1024), generator=g, device="cuda", dtype=torch.uint8)
    sym = awgn_symbols(code, numeric, data, 3.0, generator=g, device="cuda")
    n = 8192 * code.R
    before = stats()
    for p in range(4):
        stream.push(sym[:, p * n:(p + 1) * n])
    rows.append({"card": tag, "traffic": "StreamingDecoder 3 dB, 8192-step pushes", "calls": 4,
                 "rewalks": share(before, stats())})
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_segments needs a CUDA device")
    _build.library()
    tag = card_tag()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for words in ("3dB", "random"):
        rows += time_walks(VITERBI27, 8198, g, tag, words)
        rows += [r for r in time_walks(VITERBI27, 8248, g, tag, words)
                 if r["walk"].startswith("inplace bits")]
        rows += time_walks(VITERBI29, 4104, g, tag, words)
    rows += traffic(tag, g)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 1 if any(r.get("errors") for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
