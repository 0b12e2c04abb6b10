"""Measure the K > 15 walks on one GPU.

    python3 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_walk

Builds the kernels as the port does, measures the card's dependent-load
latency (one thread chasing a random cycle through 256 MiB, the unit of the
walks' bound), then holds each walk kernel against its plain version and
times both with CUDA events:

* the table walk (``walk.chainback_planes`` / ``chainback_plane_bits``) on
  tables that ``radix_planes.build_plane_tables`` makes of random K=17 words
  (both widths, anchors 0 and K-1, lengths that leave width 4, 2 and 1
  windows, end states as an int, an int32 ``[B]`` and a uint8 0-d tensor, bits
  and bytes), and on the f8 and f4 tables of the depth-4 fields kernels at
  ICE soft8, B=8, 8-byte frames (T = 87);
* the words walk (``kernels.chainback_tb``, which takes any K up to 24) on
  random K=16 and K=17 words, batch-major and ``[Tp, W, B]``, and on the ICE
  words of ``acs_update_large4`` at the same shape;

then the ICE chainback phases through ``phase_fns`` (f8 and f4) and through
``ViterbiDecoder``, and the runner's viterbi224 ``gpu_cuda`` rows.  Every
line carries the card's name and power limit.  Exits non-zero on a mismatch.
Needs a CUDA device.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys

import numpy as np
import torch

from .. import VITERBI224, CodeSpec, ViterbiDecoder, soft8_spec
from ..ops import acs, radix_planes as rp
from ..ops.cuda import _build, dispatch, kernels, large_k4, walk
from ..ops.encoder import encode_frames
from ..utils.bits import count_bit_errors

SEED = 11
K16 = CodeSpec("k16r2", 16, 2, (0o123456, 0o165473))
K17 = CodeSpec("k17r2", 17, 2, (0o345567, 0o251331))


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


def graph_ms(fn, iters: int) -> float:
    """Device time a call: ``iters`` calls captured as one CUDA graph, a
    replay timed with CUDA events.  A walk launch is shorter than the Python
    that issues it, so ``timed_ms`` measures the host there."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def load_latency_ns(n_words: int = 1 << 26, steps: int = 8192, seed: int = SEED) -> float:
    """The card's dependent-load latency, ns: one thread follows ``steps``
    links of a random cycle through ``n_words`` int32 words (256 MiB, five
    times the L2), timed against a chase of one link."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    perm = torch.randperm(n_words, device="cuda", generator=g, dtype=torch.int64)
    nxt = torch.empty(n_words, dtype=torch.int32, device="cuda")
    nxt[perm] = perm.roll(-1).to(torch.int32)
    del perm
    out = torch.empty(1, dtype=torch.int32, device="cuda")
    fn = _build.library()["viterbi_chase"]

    def chase(n):
        err = fn(nxt.data_ptr(), n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"viterbi_chase: CUDA error {err}")

    long_ms = min(timed_ms(lambda: chase(steps), 1) for _ in range(3))
    short_ms = min(timed_ms(lambda: chase(1), 1) for _ in range(3))
    del nxt
    return (long_ms - short_ms) * 1e6 / (steps - 1)


def plan_fetches(T: int, anchor: int, maxw: int) -> int:
    """Dependent fetches of a frame's table walk: one a window (a width-2
    window's two loads are independent of each other)."""
    return len(rp.plane_plan(T, anchor, maxw))


def walk_rounds(T: int) -> int:
    """Dependent fetches of a frame's words walk: one a round of five steps."""
    return -(-T // 5)


def err_of(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return 1 << 31
    if torch.equal(a, b):
        return 0
    a = a.cpu().numpy().view(np.uint32 if a.dtype == torch.int32 else np.uint8).astype(np.int64)
    b = b.cpu().numpy().view(np.uint32 if b.dtype == torch.int32 else np.uint8).astype(np.int64)
    return int(np.abs(a - b).max())


def random_words(code: CodeSpec, T: int, B: int, g) -> torch.Tensor:
    """Time-major ``[T, B, W]`` int32, every bit random."""
    return torch.randint(-2**31, 2**31, (T, B, code.decision_words), dtype=torch.int32,
                         device="cuda", generator=g)


def plane_cases(g) -> int:
    """The table walk against ``radix_planes.chainback_plane_bits`` on random
    K=17 words; returns the largest difference."""
    worst = 0
    B = 5
    ends = (0, torch.randint(0, K17.num_states, (B,), dtype=torch.int32, device="cuda",
                             generator=g), torch.tensor(201, dtype=torch.uint8, device="cuda"))
    for T in (45, 80, 87, 83):
        w_tm = random_words(K17, T, B, g)
        for anchor in (0, K17.K - 1):
            for maxw in (4, 8):
                tabs = rp.build_plane_tables(K17, w_tm, anchor, None, maxw)
                nbits = (T - K17.K + 1) // 8 * 8
                for end in ends:
                    bits_k, st_k = walk.chainback_plane_bits(K17, w_tm, tabs, nbits, end, anchor)
                    bits_r, st_r = rp.chainback_plane_bits(K17, w_tm, tabs, nbits, end, anchor)
                    by_k = walk.chainback_planes(K17, w_tm, tabs, nbits, end, anchor)
                    by_r = walk.chainback_planes_ref(K17, w_tm, tabs, nbits, end, anchor)
                    worst = max(worst, err_of(bits_k, bits_r), err_of(st_k, st_r),
                                err_of(by_k, by_r))
                # the table alone, as the fields kernels' callers walk it
                only = {f"f{maxw}": tabs[f"f{maxw}"][: (T - anchor) // maxw]}
                worst = max(worst, err_of(walk.chainback_planes(K17, None, only, 8, 3, anchor),
                                          walk.chainback_planes_ref(K17, None, only, 8, 3, anchor)))
    return worst


def words_cases(g) -> int:
    """The words walk against its plain version on random K=16 and K=17
    words, batch-major (a permuted view) and ``[Tp, W, B]``."""
    worst = 0
    for code, B, T in ((K16, 3, 50), (K17, 9, 87), (K16, 8, 1)):
        w_bt = random_words(code, T, B, g).transpose(0, 1).contiguous()  # [B, T, W]
        end = torch.randint(0, code.num_states, (1, B), dtype=torch.int32, device="cuda",
                            generator=g)
        for dec in (w_bt.permute(1, 2, 0), w_bt.permute(1, 2, 0).contiguous()):
            worst = max(worst, err_of(kernels.chainback_tb(code, dec, end, T),
                                      kernels.chainback_tb_ref(code, dec, end, T)))
    return worst


def ice_inputs(B: int, rng, noise: int = 3):
    code, numeric = VITERBI224, soft8_spec(2)
    data = rng.integers(0, 256, size=(B, 8), dtype=np.uint8)
    clean = encode_frames(code, numeric, torch.from_numpy(data)).numpy()
    sym = clean + rng.integers(-noise, noise + 1, size=clean.shape) if noise else clean
    sym = np.clip(sym, numeric.soft_low, numeric.soft_high).astype(np.int32)
    return data, torch.from_numpy(sym).cuda().reshape(B, -1, code.R)


def ice_tables(tag, rng, lat_ns) -> int:
    """Both kernels at ICE B=8 T=87 on the update kernels' own outputs,
    against their plain versions, timed beside them and their bound."""
    code, numeric, B = VITERBI224, soft8_spec(2), 8
    _, sym = ice_inputs(B, rng)
    T = sym.shape[1]
    m0 = acs.init_metrics(code, numeric, B, device="cuda")
    worst = 0
    end = torch.randint(0, code.num_states, (B,), dtype=torch.int32, device="cuda")
    for width, fn, lead, anchor in ((8, large_k4.acs_update_large4_fields8, 7, 23),
                                    (4, large_k4.acs_update_large4_fields, 3, 23)):
        _, tab, _ = fn(code, numeric, m0, sym, lead)
        tabs = {f"f{width}": tab[(anchor - lead) // width:]}
        args = (code, None, tabs, 64, end, anchor)
        e = err_of(walk.chainback_planes(*args), walk.chainback_planes_ref(*args))
        worst = max(worst, e)
        ms = graph_ms(lambda: walk.chainback_planes(*args), 50)
        host = timed_ms(lambda: walk.chainback_planes(*args), 50)
        plain = timed_ms(lambda: walk.chainback_planes_ref(*args), 3)
        nf = plan_fetches(T, anchor, width)
        print(f"[{tag}] chainback_planes ice f{width} B={B} T={T} anchor {anchor}: "
              f"max_abs_err {e}, kernel {ms:.4f} ms (graph; issued from Python {host:.4f}), plain {plain:.4f} ms, "
              f"bound {nf} fetches x {lat_ns:.1f} ns = {nf * lat_ns * 1e-6:.4f} ms")
        del tab, tabs
    _, words, _ = large_k4.acs_update_large4(code, numeric, m0, sym)
    dec = words.permute(1, 2, 0)  # [T, W, B] view of the batch-major words
    end2 = end.reshape(1, B)
    e = err_of(kernels.chainback_tb(code, dec, end2, T),
               kernels.chainback_tb_ref(code, dec, end2, T))
    worst = max(worst, e)
    ms = graph_ms(lambda: kernels.chainback_tb(code, dec, end2, T), 50)
    host = timed_ms(lambda: kernels.chainback_tb(code, dec, end2, T), 50)
    plain = timed_ms(lambda: kernels.chainback_tb_ref(code, dec, end2, T), 2)
    nr = walk_rounds(T)
    print(f"[{tag}] chainback_tb ice words B={B} T={T}: max_abs_err {e}, kernel {ms:.4f} ms (graph; "
          f"issued from Python {host:.4f}), plain {plain:.4f} ms, bound {nr} rounds x "
          f"{lat_ns:.1f} ns = {nr * lat_ns * 1e-6:.4f} ms "
          f"({T} steps x {lat_ns:.1f} ns = {T * lat_ns * 1e-6:.4f} ms a step a fetch)")
    del words, dec
    torch.cuda.empty_cache()
    return worst


def ice_phases(tag, rng) -> bool:
    """The ICE chainback phases through ``phase_fns`` (f8, and f4 for 7 of 8
    bytes) and ``ViterbiDecoder``: bytes and times."""
    code, numeric, B = VITERBI224, soft8_spec(2), 8
    data, clean = ice_inputs(B, rng, 0)
    ok = True
    for nbits, route in ((64, "f8"), (56, "f4")):
        init_fn, update_fn, chainback_fn, prepare_fn, make_cb, _ = dispatch.phase_fns(
            code, numeric, nbits, B)
        _, table, _ = update_fn(init_fn(B), prepare_fn(clean))
        out = chainback_fn(table)
        errors = count_bit_errors(out, data[:, :nbits // 8])
        ok &= errors == 0 and set(table) == {route}
        ms = timed_ms(lambda: chainback_fn(table), 20)
        chain = timed_ms(lambda: make_cb(16)(table), 3) / 16
        print(f"[{tag}] phase_fns ICE B={B} {route} route: bit errors {errors}; chainback phase "
              f"{ms:.4f} ms = {B * nbits / (ms * 1e-3) / 1e6:.4g} Mbit/s; a link of a 16-link "
              f"chain {chain:.4f} ms = {B * nbits / (chain * 1e-3) / 1e6:.4g} Mbit/s")
        del table
    dec = ViterbiDecoder(code, numeric, B, "cuda")
    dec.update(clean)
    _build.reset_launch_counts()
    out = dec.chainback(64)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    errors = count_bit_errors(out, data)
    ok &= errors == 0 and launches == {"chainback_tb": 1}
    ms = timed_ms(lambda: dec.chainback(64), 20)
    print(f"[{tag}] decoder ICE B={B}: bit errors {errors}, chainback launches {launches}; "
          f"chainback phase {ms:.4f} ms = {B * 64 / (ms * 1e-3) / 1e6:.4g} Mbit/s")
    del dec
    torch.cuda.empty_cache()
    return ok


def runner_rows(tag, sampling_time: float, minimum_samples: int) -> None:
    """The runner's viterbi224 ``gpu_cuda`` rows in-process."""
    from . import runner

    out = io.StringIO()
    saved, sys.stderr = sys.stderr, io.StringIO()
    try:
        runner.run_matrix(sampling_time, minimum_samples, out, codes=(VITERBI224,), seed=0,
                          backends=["cuda"])
    finally:
        sys.stderr = saved
    for r in json.loads(out.getvalue()):
        cb = np.asarray(r["chainback_ns"], dtype=np.float64)
        rates = r["total_input_bytes"] * 8 / (cb * 1e-9)
        print(f"[{tag}] runner {r['name']} K={r['K']}: chainback {rates.mean() / 1e6:.6g} Mbit/s "
              f"(std/mean {rates.std() / rates.mean():.3f}, samples {len(cb)}, "
              f"{cb.mean() / 1e6:.5f} ms), bit error rate {r['bit_error_rate']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_walk: no CUDA device", file=sys.stderr)
        return 2
    _build.library()
    tag = card_tag()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    lat = load_latency_ns()
    print(f"[{tag}] dependent-load latency over 256 MiB: {lat:.2f} ns")
    e_planes = plane_cases(g)
    print(f"[{tag}] chainback_planes / chainback_plane_bits vs plain, K=17 random words: "
          f"max_abs_err {e_planes}")
    e_words = words_cases(g)
    print(f"[{tag}] chainback_tb vs plain, K=16/17 random words: max_abs_err {e_words}")
    e_ice = ice_tables(tag, rng, lat)
    ok = ice_phases(tag, rng)
    runner_rows(tag, 0.3, 8)
    if e_planes or e_words or e_ice or not ok:
        print("FAIL: a walk kernel disagrees with its plain version, or a decode failed")
        return 1
    print(f"[{tag}] probe_walk: all bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
