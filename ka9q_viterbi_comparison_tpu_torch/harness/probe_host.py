"""Where the spread of a ``gpu_torch`` runner sample comes from.

    python -m ka9q_viterbi_comparison_tpu_torch.harness.probe_host --out probe_host.json

The portable path is a Python loop of small launches, so the runner times it
with host-driven chains of about ``bench.HOST_CHAIN_NS`` (``harness/bench.py``)
and its rows can break the gate's 15 % std rule.  This probe takes 20
samples of the runner's own chains a phase -- viterbi29 soft8 B=512 update
and chainback, viterbi224 soft8 B=8 chainback -- the cyclic garbage
collector on and off in turns, and prints beside each sample's CUDA-event
time the wall clock, the process's CPU time, the host's steal time
(``/proc/stat``), the process's context switches and the collector's passes.
CPU time near the wall time with no steal says the process ran all along, so
a spread that stays with the collector off is the host's own speed.  On the
card unless ``--device cpu`` is given (tiny frames there: a check of the
plumbing, not a measurement).
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import time

import numpy as np
import torch

from ..configs import BENCH_FRAME_BYTES, STANDARD_CODES, soft8_spec
from ..models.decoder import as_symbols, resolve_device
from ..ops.encoder import encode_frames
from . import bench

__all__ = ["main", "probe", "summary", "CASES", "SAMPLES"]

CASES = (("viterbi29", 512, ("update", "chainback")), ("viterbi224", 8, ("chainback",)))
SAMPLES = 20


def _steal_ticks() -> int:
    with open("/proc/stat") as f:
        fields = f.readline().split()
    return int(fields[8]) if len(fields) > 8 else 0


def _gc_passes() -> int:
    return sum(s["collections"] for s in gc.get_stats())


def probe(device: torch.device, samples: int = SAMPLES) -> list[dict]:
    """One record a sample, odd samples with the collector off."""
    small = device.type == "cpu"
    codes = {c.name: c for c in STANDARD_CODES}
    out = []
    for name, batch, phases in CASES:
        code = codes[name]
        if small and code.K > 15:
            continue  # 2^23 states take minutes a step on the host
        B, n_bytes = (2, 2) if small else (batch, BENCH_FRAME_BYTES[name])
        numeric = soft8_spec(code.R)
        data = np.random.default_rng(0).integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
        sym = as_symbols(encode_frames(code, numeric, torch.from_numpy(data)), device)
        init_fn, update_fn, cb_fn, prepare_fn, make_cb, make_up = bench._phases_for_backend(
            code, numeric, "torch", n_bytes * 8, B, device)
        prepared = prepare_fn(sym.reshape(B, -1, code.R))
        metrics = init_fn(B)
        _, words, _ = update_fn(metrics, prepared)
        cb_fn(words)
        bench.sync()
        for phase in phases:
            if phase == "update":
                probe_ns = bench._timed_ns(lambda: update_fn(metrics, prepared), device)[0]
                chain = make_up(bench._links_for(probe_ns, bench.HOST_CHAIN_NS))
                run = lambda: chain(metrics, prepared)  # noqa: E731
            else:
                probe_ns = bench._timed_ns(lambda: cb_fn(words), device)[0]
                chain = make_cb(bench._links_for(probe_ns, bench.HOST_CHAIN_NS))
                run = lambda: chain(words)  # noqa: E731
            links = bench._links_for(probe_ns, bench.HOST_CHAIN_NS)
            for i in range(4 if small else samples):
                gc_off = i % 2 == 1
                if gc_off:
                    gc.disable()
                try:
                    ru0, st0, g0 = resource.getrusage(resource.RUSAGE_SELF), _steal_ticks(), _gc_passes()
                    w0, c0 = time.perf_counter(), time.process_time()
                    ns, _ = bench._timed_ns(run, device)
                    w1, c1 = time.perf_counter(), time.process_time()
                    ru1, st1, g1 = resource.getrusage(resource.RUSAGE_SELF), _steal_ticks(), _gc_passes()
                finally:
                    gc.enable()
                rec = dict(code=name, phase=phase, links=links, gc_off=gc_off, ms=ns / 1e6,
                           wall_ms=(w1 - w0) * 1e3, cpu_ms=(c1 - c0) * 1e3,
                           steal_ticks=st1 - st0, nivcsw=ru1.ru_nivcsw - ru0.ru_nivcsw,
                           nvcsw=ru1.ru_nvcsw - ru0.ru_nvcsw, gc_passes=g1 - g0)
                out.append(rec)
                print(json.dumps(rec), flush=True)
    return out


def summary(records: list[dict]) -> list[str]:
    """A line a phase: the samples' CV with the collector on and off, CPU
    time over wall time, steal ticks, involuntary switches, collector passes."""
    lines = []
    for key in dict.fromkeys((r["code"], r["phase"]) for r in records):
        rs = [r for r in records if (r["code"], r["phase"]) == key]
        ms = np.array([r["ms"] for r in rs])
        cv = {off: np.std([r["ms"] for r in rs if r["gc_off"] == off])
              / np.mean([r["ms"] for r in rs if r["gc_off"] == off]) for off in (False, True)}
        cpu = [r["cpu_ms"] / r["wall_ms"] for r in rs]
        lines.append(
            f"{key[0]} {key[1]}: {rs[0]['links']} links a sample, {len(rs)} samples, CV "
            f"{ms.std() / ms.mean():.1%} (collector on {cv[False]:.1%}, off {cv[True]:.1%}); CPU "
            f"time {min(cpu):.3f}-{max(cpu):.3f} of wall; steal {sum(r['steal_ticks'] for r in rs)} "
            f"ticks; involuntary switches {sum(r['nivcsw'] for r in rs)}; collector passes "
            f"{min(r['gc_passes'] for r in rs)}-{max(r['gc_passes'] for r in rs)} a sample")
    return lines


def main(argv=None) -> None:
    p = argparse.ArgumentParser("probe_host")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also write the records here")
    args = p.parse_args(argv)
    records = probe(resolve_device(args.device))
    for line in summary(records):
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)


if __name__ == "__main__":
    main()
