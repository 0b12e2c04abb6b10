"""Measure the launches around the K <= 15 kernels on one GPU: the
decoder's update phase, the stream push, the decoder's traceback phase and
the time-block shard body.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_glue [--out FILE] [--label NAME]

First it times the whole-frame ACS kernels at the shapes of ``PERF.md``'s
kernel table (rows 1, 3 and 5: ``acs_update_tb`` K=7 and K=9 soft16 at
B=64, ``acs_update_inplace`` K=7 and K=9 soft16 at B=512 and Cassini at
B=256, ``acs_update_tb2`` K=7 and K=9 soft16 at B=1024) by CUDA events on
their ``[Tp, R, B]`` and ``[S, B]`` inputs and, where the kernels take them,
on batch-major views of the same values.  Then, for each of four paths, it prints, and writes to ``--out`` as JSON, the
device operations one call issues (kernels, copies and fills of any origin,
counted in a profiler trace of the call after a warm-up; the largest of three
traces), the device time a call by CUDA events, and the host's microseconds
to issue a call:

* the decoder's whole-frame update (``ViterbiDecoder.update`` of a whole
  frame from step 0; the decoder is put back at step 0 outside every
  measurement): K=7 soft8 1024-byte frames at B=512 (the in-place pair) and
  B=64 (the state-order pair), Cassini 256-byte frames at B=256 (the
  in-place pair), beside the update kernel alone on the decoder's own
  batch-major inputs (on a checkout whose kernels refuse views, on their
  ``[Tp, R, B]`` and ``[S, B]`` copies, as ``kernel_input`` says) and the
  chainback phase after it; Cassini B=64 and ICE B=8 (the large-K route) as
  controls.  Its device time is taken two ways: calls queued behind a spin
  kernel (``ms``, ``queued_ms``: the device's time a call, as a caller that
  keeps the card busy sees it; the kernel alone is timed the same way) and
  one call on an idle card after a synchronisation (``idle_call_ms``: the
  host's issue until the last launch is inside it);
* streams through ``StreamingDecoder(backend="cuda")``: K=7 soft8 in pushes
  of 2046 steps at B=512 (the in-place pair) and B=64 (the state-order
  pair), 14 steady pushes after two, beside the batch update rate of the
  same code and batch on 1024-byte frames;
* the decoder's chainback phase (``ViterbiDecoder.chainback``) at K=7 B=512
  and B=64 on 1024-byte frames, Cassini B=256 on 256-byte frames and ICE B=8
  on 8-byte frames, beside its walk kernel alone (the words form on the
  decoder's words) and the reference's chainback column (``BASELINE.md``);
* the time-block shard body (``parallel.timeblock._time_block_shards``) at
  K=7 soft8 B=64, 1024-byte frames padded to 8200 steps, overlap 56, on
  in-process meshes (frame=2, time=4) and time=8 on this card, and the
  whole ``time_block_decode_bits`` call.

Every line carries the card's name and power limit.  Needs a CUDA device.
It imports the package by absolute name and only the entry points that
earlier checkouts have, so the same file measures another checkout: ``cd
OTHER && PYTHONPATH=. python3 PATH/TO/probe_glue.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ka9q_viterbi_comparison_tpu_torch import (VITERBI27, VITERBI29, VITERBI224, VITERBI615,
                                               StreamingDecoder, ViterbiDecoder, parallel,
                                               soft8_spec, soft16_spec)
from ka9q_viterbi_comparison_tpu_torch.ops import acs
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, dispatch, inplace, kernels, kernels2
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.parallel import timeblock

SEED = 18
# The reference decoders' chainback column, Mbit/s (BASELINE.md:19-39).
BASELINE_CHAINBACK = {"viterbi27": 86.46, "viterbi615": 4.79, "viterbi224": 3.68}


def card_tag() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
    """Device milliseconds a call: CUDA events around ``iters`` calls after
    a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int) -> float:
    """Device milliseconds a call when calls queue back to back: a spin
    kernel (``torch.cuda._sleep``, some 25 ms) holds the card while the host
    queues ``iters`` calls after a warm-up, so the events bracket the calls'
    device work and not the host's issue of the first of them (where the
    host issues slower than the card runs, the wait is inside)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Host microseconds to issue a call (no synchronisation inside the
    timed loop; the queue drains after it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def device_ops(fn, traces: int = 3) -> int:
    """Device operations of one call, the largest count of ``traces``
    profiler traces (a trace may miss events, never add them); -1 where
    the profiler recorded none."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best = -1
    for _ in range(traces):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        best = max(best, n if n else -1)
    return best


def noisy(code, B, n_bytes, rng, noise=3):
    numeric = soft8_spec(code.R)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = encode_frames(code, numeric, torch.from_numpy(data)).reshape(B, -1, code.R)
    sym = sym + torch.from_numpy(rng.integers(-noise, noise + 1, size=tuple(sym.shape)))
    return torch.clamp(sym, numeric.soft_low, numeric.soft_high).to(torch.int32).cuda()


def streams(tag, rng, out):
    code, numeric, n, pushes = VITERBI27, soft8_spec(2), 2046, 16
    for B in (512, 64):
        sym = torch.from_numpy(rng.integers(-127, 128, size=(B, pushes * n, 2))
                               .astype(np.int32)).cuda()
        dec = StreamingDecoder(code, numeric, B)
        for i in range(2):
            dec.push(sym[:, i * n:(i + 1) * n])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(2, pushes - 1):
            dec.push(sym[:, i * n:(i + 1) * n])
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        steady = pushes - 3
        ms = start.elapsed_time(end) / steady
        us = 1e6 * (t1 - t0) / steady
        last = sym[:, (pushes - 1) * n:]
        ops = device_ops(lambda: dec.push(last))
        frames = noisy(code, B, 1024, rng)
        vdec = ViterbiDecoder(code, numeric, B, "cuda")

        def update():
            vdec.reset()
            vdec.update(frames)

        upd = event_ms(update, 5)
        rate = B * n * code.R / (ms * 1e-3) / 1e6
        batch = B * frames.shape[1] * code.R / (upd * 1e-3) / 1e6
        route = "in-place" if dispatch.use_inplace(code, B, "cuda") else "state-order"
        print(f"[{tag}] stream K=7 B={B} ({route}) {n}-step pushes: {ms:.4f} ms a push "
              f"({steady} steady pushes by CUDA events) = {rate:.1f} Msym/s; host {us:.1f} us to "
              f"issue a push; {ops} device operations a push; batch update {upd:.4f} ms = "
              f"{batch:.1f} Msym/s", flush=True)
        out[f"stream_k7_b{B}"] = {"ms": ms, "msym_s": rate, "host_us": us, "device_ops": ops,
                                  "batch_update_ms": upd, "batch_msym_s": batch}
        del dec, vdec, sym, frames
        torch.cuda.empty_cache()


def at_step_0(dec, m0, off0):
    """Put ``dec`` back at step 0 with no device operation (``reset`` fills
    tensors on the card): the reset metrics ``m0`` and offset ``off0``, no
    words.  Every checkout takes ``_decision_blocks = []``."""
    dec.metrics, dec.renorm_offset, dec._steps = m0, off0, 0
    dec._decision_blocks = []


def rows(tag, rng, out):
    """The whole-frame ACS kernels at the kernel table's shapes, on
    ``[Tp, R, B]`` and ``[S, B]`` inputs and on batch-major views of them."""
    cases = (("acs_update_tb", kernels.acs_update_tb, VITERBI27, soft8_spec(2), 64, 1024),
             ("acs_update_tb", kernels.acs_update_tb, VITERBI29, soft16_spec(2), 64, 512),
             ("acs_update_inplace", inplace.acs_update_inplace, VITERBI27, soft8_spec(2), 512, 1024),
             ("acs_update_inplace", inplace.acs_update_inplace, VITERBI29, soft16_spec(2), 512, 512),
             ("acs_update_inplace", inplace.acs_update_inplace, VITERBI615, soft8_spec(6), 256, 256),
             ("acs_update_tb2", kernels2.acs_update_tb2, VITERBI27, soft8_spec(2), 1024, 1024),
             ("acs_update_tb2", kernels2.acs_update_tb2, VITERBI29, soft16_spec(2), 1024, 512))
    for name, fn, code, numeric, B, n_bytes in cases:
        sym = noisy(code, B, n_bytes, rng)  # the kernels' time does not depend on the values
        T = sym.shape[1]
        m = acs.init_metrics(code, numeric, B, device="cuda")
        extra = (0,) if name == "acs_update_inplace" else ()
        forms = {"time-major": (m.T.contiguous(), sym.permute(1, 2, 0).contiguous()),
                 "batch-major": (m.T, sym.permute(1, 2, 0))}
        iters = 5 if code.K > 9 else 20
        res = {}
        for form, (m_sb, s_trb) in forms.items():
            try:
                res[form] = event_ms(lambda: fn(code, numeric, m_sb, s_trb, T, *extra), iters)
            except ValueError:
                res[form] = None
        label = f"{code.name} {numeric.name} B={B} T={T}"
        print(f"[{tag}] {name} {label}: " + "; ".join(
            f"{form} {'refused' if v is None else f'{v:.4f} ms'}" for form, v in res.items()),
            flush=True)
        out[f"{name}_{code.name}_{numeric.name}_b{B}"] = res
        del sym, m, forms
        torch.cuda.empty_cache()


def update_once(dec, sym, traced=False):
    """One update of ``dec`` on ``sym`` after a reset that is synchronised
    and left outside: ``(device ms by CUDA events, host us to issue it,
    device operations in a profiler trace where ``traced``, else None)``."""
    dec.reset()
    torch.cuda.synchronize()
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            dec.update(sym)
            torch.cuda.synchronize()
        return None, None, sum(1 for e in prof.events()
                               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    dec.update(sym)
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), 1e6 * (t1 - t0), None


def update_kernel(code, numeric, B, sym):
    """``(the update kernel of the decoder's route as a closure, what it
    reads)``: on the decoder's own batch-major symbols and reset metrics as
    views, or, where the kernel refuses views (an earlier checkout), their
    contiguous ``[Tp, R, B]`` and ``[S, B]`` copies; ``(None, "")`` on the
    large-K route."""
    T = sym.shape[1]
    if dispatch.use_inplace(code, B, "cuda"):
        fn = lambda m, s: inplace.acs_update_inplace(code, numeric, m, s, T, 0)  # noqa: E731
    elif dispatch.supports(code):
        fn = lambda m, s: dispatch._small_k_impl(B)(code, numeric, m, s, T)  # noqa: E731
    else:
        return None, ""
    m = acs.init_metrics(code, numeric, B, device="cuda")
    try:
        fn(m.T, sym.permute(1, 2, 0))
        return (lambda: fn(m.T, sym.permute(1, 2, 0))), "batch-major views"
    except ValueError:
        m_sb, s_trb = m.T.contiguous(), sym.permute(1, 2, 0).contiguous()
        return (lambda: fn(m_sb, s_trb)), "[Tp, R, B] and [S, B] copies"


def updates(tag, rng, out):
    for code, B, n_bytes in ((VITERBI27, 512, 1024), (VITERBI27, 64, 1024),
                             (VITERBI615, 256, 256), (VITERBI615, 64, 256), (VITERBI224, 8, 8)):
        numeric = soft8_spec(code.R)
        sym = noisy(code, B, n_bytes, rng)
        dec = ViterbiDecoder(code, numeric, B, "cuda")
        m0, off0 = dec.metrics, dec.renorm_offset
        ms = queued_ms(lambda: (at_step_0(dec, m0, off0), dec.update(sym)), 10)
        runs = [update_once(dec, sym) for _ in range(9)][1:]
        idle = float(np.median([r[0] for r in runs]))
        us = float(np.median([r[1] for r in runs]))
        ops = max(update_once(dec, sym, traced=True)[2] for _ in range(3))
        cb = event_ms(lambda: dec.chainback(8 * n_bytes), 10)
        kernel, kernel_input = update_kernel(code, numeric, B, sym)
        k_ms = queued_ms(kernel, 10 if code.K <= 9 else 3) if kernel else None
        T = sym.shape[1]
        rate = B * T * code.R / (ms * 1e-3) / 1e6
        route = ("in-place" if dispatch.use_inplace(code, B, "cuda") else
                 "state-order" if dispatch.supports(code) else "large-K")
        print(f"[{tag}] decoder {code.name} B={B} ({route}) update phase {ms:.4f} ms = "
              f"{rate:.1f} Msym/s (queued calls); {ops} device operations"
              + (f"; the kernel alone {k_ms:.4f} ms on {kernel_input} (update / kernel "
                 f"{ms / k_ms:.3f})" if kernel else "")
              + f"; chainback phase {cb:.4f} ms; update and chainback {ms + cb:.4f} ms; one call "
              f"on an idle card {idle:.4f} ms (median of 8), host {us:.1f} us to issue it",
              flush=True)
        out[f"update_{code.name}_b{B}"] = {
            "route": route, "ms": ms, "msym_s": rate, "idle_call_ms": idle, "host_us": us,
            "device_ops": ops, "kernel_ms": k_ms, "kernel_input": kernel_input,
            "chainback_ms": cb, "decode_ms": ms + cb}
        del dec, sym, kernel
        torch.cuda.empty_cache()


def tracebacks(tag, rng, out):
    for code, B, n_bytes in ((VITERBI27, 512, 1024), (VITERBI27, 64, 1024),
                             (VITERBI615, 256, 256), (VITERBI224, 8, 8)):
        numeric = soft8_spec(code.R)
        nbits = 8 * n_bytes
        dec = ViterbiDecoder(code, numeric, B, "cuda")
        dec.update(noisy(code, B, n_bytes, rng))
        ms = event_ms(lambda: dec.chainback(nbits), 20)
        us = host_us(lambda: dec.chainback(nbits), 20)
        ops = device_ops(lambda: dec.chainback(nbits))
        words = torch.cat(dec._decision_blocks, dim=1).permute(1, 2, 0)  # [T, W, B]
        T = words.shape[0]
        end = torch.zeros((1, B), dtype=torch.int32, device="cuda")
        if dispatch.use_inplace(code, B, "cuda"):
            walk = lambda: inplace.chainback_inplace(code, words, end, T, 0)  # noqa: E731
        else:
            walk = lambda: kernels.chainback_tb(code, words, end, T)  # noqa: E731
        kernel = event_ms(walk, 20)
        mbit = B * nbits / (ms * 1e-3) / 1e6
        print(f"[{tag}] decoder {code.name} B={B} chainback phase {ms:.4f} ms = {mbit:.4g} Mbit/s "
              f"(reference column {BASELINE_CHAINBACK[code.name]} Mbit/s); its walk kernel alone "
              f"{kernel:.4f} ms (phase / kernel {ms / kernel:.3f}); host {us:.1f} us to issue; "
              f"{ops} device operations", flush=True)
        out[f"chainback_{code.name}_b{B}"] = {"ms": ms, "mbit_s": mbit, "kernel_ms": kernel,
                                              "host_us": us, "device_ops": ops}
        del dec, words
        torch.cuda.empty_cache()


def time_blocks(tag, rng, out):
    code, numeric, B, OL = VITERBI27, soft8_spec(2), 64, 56
    sym = noisy(code, B, 1024, rng)
    sym = torch.nn.functional.pad(sym, (0, 0, 0, (-sym.shape[1]) % 8))
    for axes in ({"frame": 2, "time": 4}, {"time": 8}):
        mesh = parallel.Mesh(axes, "cuda")
        spec = ("frame" if "frame" in axes else None, "time")
        blk = mesh.shard(sym, spec)

        def body():
            return timeblock._time_block_shards(code, numeric, mesh, blk, OL, "time")

        def whole():
            return parallel.time_block_decode_bits(code, numeric, sym, mesh, overlap=OL)

        name = "x".join(f"{k}{v}" for k, v in axes.items())
        res = {"body_ms": event_ms(body, 10), "body_host_us": host_us(body, 10),
               "body_device_ops": device_ops(body), "call_ms": event_ms(whole, 10),
               "call_device_ops": device_ops(whole)}
        _build.reset_launch_counts()
        body()
        torch.cuda.synchronize()
        res["body_launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
        print(f"[{tag}] time-block body K=7 B={B} on {axes}, overlap {OL}: "
              f"{res['body_device_ops']} device operations, {res['body_ms']:.4f} ms, host "
              f"{res['body_host_us']:.1f} us to issue, port kernels {json.dumps(res['body_launches'])}; "
              f"the whole call {res['call_device_ops']} device operations, {res['call_ms']:.4f} ms",
              flush=True)
        out[f"timeblock_{name}"] = res
        del blk, mesh
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    ap.add_argument("--label", default="", help="a name for this checkout in the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_glue: no CUDA device")
    _build.library()
    tag = card_tag()
    if args.label:
        tag = f"{tag}; {args.label}"
    rng = np.random.default_rng(SEED)
    out = {"card": card_tag(), "label": args.label}
    rows(tag, rng, out)
    updates(tag, rng, out)
    streams(tag, rng, out)
    tracebacks(tag, rng, out)
    time_blocks(tag, rng, out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
