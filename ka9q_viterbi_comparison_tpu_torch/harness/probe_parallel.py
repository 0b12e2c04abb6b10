"""Probe the multi-device paths across cards: one shard a rank, over NCCL.

    torchrun --nproc_per_node 4 -m ka9q_viterbi_comparison_tpu_torch.harness.probe_parallel

Each rank runs on its own card (``parallel.multihost.initialize`` from the
``env://`` rendezvous torchrun sets up).  Four paths, each with one shard a
rank:

* frame DP: VITERBI27 soft8, 1024-byte frames, 512 a rank (the in-place pair
  on every card);
* time blocks: 512 VITERBI27 frames of 1024 bytes (padded to a multiple of
  the ranks), one time block a rank, overlap 56, the halos over NCCL;
* state sharding: VITERBI224 (ICE) soft8, 8-byte frames, B=8, the state
  axis over the ranks (four half-shard ppermutes and a psum a step over
  NCCL, the step on the shard kernel, ``sharded_acs_scan``; the scan and
  its traceback each planned once, ``statewise._plan_scan`` and
  ``_walk_steps``, so a step issues one launch and its NCCL calls);
* state x time: one 64-byte ICE frame (T = 535, padded to 536) on (state=2,
  time=2), overlap 96: each rank its (state, time) shard of the trellis,
  96 warm-up and 364 main steps on the shard kernel, each with the state
  axis's ppermutes, and its traceback's psums, over NCCL.

Rank 0 decodes the same frames unsharded on its card (the kernels), and the
time-block, state-sharded and state x time ones also through the same
sharded function on an in-process mesh of as many shards on its one card.
The ranks' bytes must equal the unsharded decode (noiseless and noisy frame
DP, noiseless time blocks, noisy ICE, the state x time frame) and the
in-process run (noisy time blocks, the state x time bits).  Each path
prints its time (the slowest rank, host clock around synchronised runs,
median of three after a warm-up), the measured scaling efficiency beside the
analytic model's prediction at the H100 figures (``harness/comms.py``), and
the collectives that rank 0 counted.  Rank 0 traces one noisy time-block
run and one state-sharded run (device time by operation, the trace under
``chiprun_out/``), and splits one state-sharded and one state x time run
into scan and traceback by CUDA events, beside the host clock's
microseconds a step of their issue; it also traces one state x time run
and counts, in each traced decode, the host's ``cudaStreamSynchronize``
calls and copies from pageable memory, the device's idle share of the
traced span, and the kernel launches of a decode (the traceback's step
kernel once a step: its state lines span the ranks).  Results also go to
``chiprun_out/probe_parallel.json``.

``--device cpu`` runs the same program on gloo in CPU processes at small
sizes (K=7 64-byte frames, VITERBI29 in place of ICE, a 32-byte frame and
overlap 32 for state x time), every shard step on its plain version: a
rehearsal of the control flow, no measurement.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import VITERBI27, VITERBI29, VITERBI224, soft8_spec
from ..models.functional import decode_symbols
from ..ops.cuda import _build
from ..ops.encoder import encode_frames
from ..parallel import (Mesh, frame_sharded_decode, multihost, pad_to_time_blocks,
                        state_sharded_decode, state_time_decode_bits, time_block_decode_bits)
from ..utils.bits import bits_to_bytes
from . import comms, profiling

SEED = 20261017


def _card_tags() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()


def _frames(code, B, n_bytes, noise, seed):
    """Seeded frames, alike on every rank: ``(data, symbols [B, T, R] int32)`` on the CPU."""
    numeric = soft8_spec(code.R)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = encode_frames(code, numeric, torch.from_numpy(data)).reshape(B, -1, code.R)
    if noise:
        sym = sym + torch.from_numpy(rng.integers(-noise, noise + 1, size=tuple(sym.shape)))
    return data, sym.clamp(numeric.soft_low, numeric.soft_high).to(torch.int32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device, reps=3):
    """Output of ``fn`` and the median over ``reps`` of the slowest rank's
    seconds (after one warm-up run)."""
    out = fn()
    times = []
    for _ in range(reps):
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        times.append(float(t))
    return out, float(np.median(times))


def _local_timed(fn, device, reps=3):
    """As ``_timed``, for a run on this rank alone."""
    out = fn()
    times = []
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def _phase_split(fn, device) -> tuple[float, float, float, float]:
    """One more run of ``fn`` on every rank, its scans and its tracebacks
    between CUDA events: this rank's ``(scan ms, traceback ms, scan issue
    ms, traceback issue ms)``, the last two on the host clock."""
    dist.barrier()
    with profiling.sharded_phase_spans() as spans:
        fn()
    _sync(device)
    return (*(sum(a.elapsed_time(b) for a, b in spans[k]) for k in ("scan", "traceback")),
            *(1e3 * sum(spans["host_s"][k]) for k in ("scan", "traceback")))


def _profile(fn, rank, log_dir, label):
    """One run of ``fn`` on every rank, rank 0's traced: its device time by
    operation and its host-side waits, beside the run's span.  Returns rank
    0's count of ``cudaStreamSynchronize`` calls and of copies from pageable
    host memory (each of which waits for the stream), else None."""
    dist.barrier()
    if rank != 0:
        fn()
        torch.cuda.synchronize()
        return None
    with profiling.device_trace(str(log_dir)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    busy = sorted(rows, key=dev, reverse=True)[:8]
    host = {e.key: e.count for e in rows
            if any(w in e.key for w in ("Synchronize", "Memcpy", "LaunchKernel", "nccl"))}
    device_ms = profiling.device_busy_ms(str(log_dir))
    waits = {"stream_syncs": sum(n for k, n in host.items() if "StreamSynchronize" in k),
             "pageable_copies": sum(n for k, n in host.items() if "Pageable" in k),
             "span_ms": 1e3 * span, "device_ms": device_ms,
             "idle_share": 1 - device_ms / (1e3 * span)}
    print(f"trace of one {label} run on rank 0: span {1e3 * span:.4f} ms, device busy "
          f"{device_ms:.4f} ms (idle {100 * waits['idle_share']:.1f}%; the operations' device "
          f"times sum to {sum(dev(e) for e in rows) / 1e3:.4f}); by operation (ms, calls): "
          + "; ".join(f"{e.key[:60]} {dev(e) / 1e3:.4f} x{e.count}" for e in busy if dev(e))
          + f"; host calls {json.dumps(host)}; {json.dumps(waits)}", flush=True)
    return waits


def _launches(fn) -> dict[str, int]:
    """The kernel launches of one more run of ``fn`` on every rank, by
    counter (this rank's)."""
    dist.barrier()
    before = dict(_build.LAUNCHES)
    fn()
    return {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}


def _gather(x: torch.Tensor) -> list[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return parts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default: NCCL, a card a rank) or cpu "
                   "(gloo, small sizes, a rehearsal)")
    p.add_argument("--out", default="chiprun_out/probe_parallel.json")
    args = p.parse_args(argv)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = multihost.initialize("env://", world, rank, args.device)
    on_card = device.type == "cuda"
    if on_card:
        if rank == 0:
            _build.library()  # one build; the other ranks load it
        dist.barrier(device_ids=[device.index])
        _build.library()
    n_bytes, B_frame, B_time = (1024, 512, 512) if on_card else (64, 16, 16)
    ice, B_ice, ice_bytes = (VITERBI224, 8, 8) if on_card else (VITERBI29, 2, 32)
    OL = 56
    soft8 = soft8_spec(2)
    nbits = n_bytes * 8
    record = {"world": world, "device": str(device)}
    if on_card and rank == 0:
        record["cards"] = _card_tags()
        print(f"cards: {record['cards']}; torch {torch.__version__} cuda {torch.version.cuda}",
              flush=True)

    def say(text):
        if rank == 0:
            print(text, flush=True)

    def report(fn):
        """Counted collectives of rank 0's run of ``fn`` (every rank runs it)."""
        rep = comms.collective_trace(fn)
        return {c.prim: sum(x.count for x in rep.collectives if x.prim == c.prim)
                for c in rep.collectives}, rep.total_wire_bytes()

    # -- frame DP -----------------------------------------------------------------------
    ok = True
    for noise in (0, 3):
        data, sym = _frames(VITERBI27, B_frame * world, n_bytes, noise, SEED + noise)
        flat = sym.reshape(sym.shape[0], -1)
        mine = flat[rank * B_frame:(rank + 1) * B_frame].to(device)
        mesh = multihost.global_frame_mesh(device=device)
        run = lambda: frame_sharded_decode(VITERBI27, soft8, mine, nbits, mesh)  # noqa: E731
        out, t_n = _timed(run, device)
        counted, wire = report(run)
        parts = _gather(out)
        if rank == 0:
            whole = flat.to(device)
            want, t_1 = _local_timed(lambda: decode_symbols(VITERBI27, soft8, whole, nbits,
                                                            backend="cuda", device=device), device)
            same = bool(torch.equal(torch.cat(parts), want))
            errors = int((torch.cat(parts).cpu().numpy() != data).sum()) if not noise else None
            ok &= same and not errors
            eff = t_1 / (world * t_n)
            model = comms.frame_model(world, B_frame * world)
            say(f"frame DP K=7 {n_bytes}-byte frames, {B_frame} a rank x {world} ranks "
                f"({'noisy' if noise else 'noiseless'}): sharded {1e3 * t_n:.4f} ms, unsharded "
                f"{B_frame * world} frames on one card {1e3 * t_1:.4f} ms, measured scaling "
                f"efficiency {eff:.4f} (model {model['predicted_efficiency']:.4f}); equal to the "
                f"unsharded decode {same}{'' if noise else f', differing bytes {errors}'}; "
                f"collectives {counted}")
            record[f"frame_dp_noise{noise}"] = {"sharded_s": t_n, "unsharded_s": t_1,
                                                "efficiency": eff, "model": model, "equal": same,
                                                "collectives": counted}

    # -- time blocks --------------------------------------------------------------------
    T = VITERBI27.transmit_bits(n_bytes)
    pad = (-T) % world
    for noise in (0, 3):
        data, sym = _frames(VITERBI27, B_time, n_bytes, noise, SEED + 10 + noise)
        sym = F.pad(sym, (0, 0, 0, pad))  # erasure symbols: soft8's midpoint is 0
        Tb = (T + pad) // world
        block = sym[:, rank * Tb:(rank + 1) * Tb].to(device)
        tmesh = multihost.cross_process_time_mesh()
        run = lambda: time_block_decode_bits(VITERBI27, soft8, block, tmesh, OL)  # noqa: E731
        bits, t_n = _timed(run, device)
        counted, wire = report(run)
        if noise and on_card:
            _profile(run, rank, pathlib.Path(args.out).parent / "probe_parallel_trace",
                     "sharded time-block")
        parts = _gather(bits)
        if rank == 0:
            got = torch.cat(parts, dim=1)
            whole = sym.to(device)
            if noise:
                inproc = Mesh({"time": world, "frame": 1}, device, spans_processes=False)
                want, t_1 = _local_timed(lambda: time_block_decode_bits(
                    VITERBI27, soft8, whole, inproc, OL), device)
                label = f"the same sharded function on one card ({world} shards)"
            else:
                want, t_1 = _local_timed(lambda: decode_symbols(
                    VITERBI27, soft8, whole[:, :T].reshape(B_time, -1), nbits, backend="cuda",
                    device=device), device)
                got = bits_to_bytes(got[:, VITERBI27.K - 1:VITERBI27.K - 1 + nbits])
                label = "the unsharded decode"
            same = bool(torch.equal(got, want))
            ok &= same
            eff = t_1 / (world * t_n)
            model = comms.timeblock_model(VITERBI27, world, B_time, T + pad, overlap=OL)
            say(f"time blocks K=7 {n_bytes}-byte frames, B={B_time}, {Tb} steps a rank, overlap "
                f"{OL} ({'noisy' if noise else 'noiseless'}): sharded {1e3 * t_n:.4f} ms, "
                f"{label} {1e3 * t_1:.4f} ms, measured scaling efficiency {eff:.4f} (model "
                f"{model['predicted_efficiency']:.4f}); equal {same}; collectives {counted}, "
                f"{wire} wire bytes (model {model['total_wire_bytes']})")
            record[f"time_blocks_noise{noise}"] = {"sharded_s": t_n, "reference_s": t_1,
                                                   "reference": label, "efficiency": eff,
                                                   "model": model, "equal": same,
                                                   "collectives": counted}

    # -- state sharding -----------------------------------------------------------------
    numeric = soft8_spec(ice.R)
    data, sym = _frames(ice, B_ice, ice_bytes, 3, SEED + 20)
    clean_data, clean = _frames(ice, B_ice, ice_bytes, 0, SEED + 21)
    mesh = Mesh({"state": world}, device)
    out, t_n = _timed(lambda: state_sharded_decode(ice, numeric, sym.to(device), ice_bytes * 8,
                                                   mesh), device)
    clean_out = state_sharded_decode(ice, numeric, clean.to(device), ice_bytes * 8, mesh)
    counted, wire = report(lambda: state_sharded_decode(
        ice, numeric, sym.to(device), ice_bytes * 8, mesh))
    if on_card:
        sw_run = lambda: state_sharded_decode(ice, numeric, sym.to(device), ice_bytes * 8,  # noqa: E731
                                              mesh)
        sw_split = _phase_split(sw_run, device)
        sw_waits = _profile(sw_run, rank,
                            pathlib.Path(args.out).parent / "probe_parallel_trace_state",
                            "state-sharded decode")
        sw_launches = _launches(sw_run)
    parts = _gather(out)
    if rank == 0:
        whole = sym.to(device)
        want, t_k = _local_timed(lambda: decode_symbols(ice, numeric, whole.reshape(B_ice, -1),
                                                        ice_bytes * 8, backend="cuda",
                                                        device=device), device)
        inproc = Mesh({"state": world}, device, spans_processes=False)
        same_inproc, t_1 = _local_timed(lambda: state_sharded_decode(
            ice, numeric, whole, ice_bytes * 8, inproc), device)
        same = all(torch.equal(p, want) for p in parts) and bool(torch.equal(same_inproc, want))
        errors = int((clean_out.cpu().numpy() != clean_data).sum())
        ok &= same and not errors
        eff = t_1 / (world * t_n)
        T_ice = ice.transmit_bits(ice_bytes)
        model = comms.statewise_model(ice, world, B_ice, T_ice)
        say(f"state sharding {ice.name} {ice_bytes}-byte frames B={B_ice} over {world} ranks: "
            f"sharded {1e3 * t_n:.4f} ms, the same function on one card ({world} shards) "
            f"{1e3 * t_1:.4f} ms, unsharded decode on the kernels {1e3 * t_k:.4f} ms; measured "
            f"scaling efficiency {eff:.4f} (model step efficiency "
            f"{model['predicted_step_efficiency']:.4f}: {model['step_wire_bytes']} wire bytes a "
            f"step); noisy equal to the unsharded decode on every rank {same}, noiseless "
            f"differing bytes {errors}; collectives {counted}, {wire} wire bytes")
        record["state_sharded"] = {"sharded_s": t_n, "one_card_s": t_1, "kernel_decode_s": t_k,
                                   "efficiency": eff, "model": model, "equal": same,
                                   "collectives": counted}
        if on_card:
            say(f"state sharding: {1e3 * t_n / T_ice:.4f} ms a step over {world} ranks; one more "
                f"run on rank 0: scan {sw_split[0]:.4f} ms ({1e3 * sw_split[0] / T_ice:.2f} us a "
                f"step; its issue on the host clock {1e3 * sw_split[2] / T_ice:.2f} us a step), "
                f"traceback {sw_split[1]:.4f} ms ({1e3 * sw_split[1] / T_ice:.2f} us a step; its "
                f"issue {1e3 * sw_split[3] / T_ice:.2f} us a step); launches a decode "
                f"{json.dumps(sw_launches)}")
            record["state_sharded"].update(scan_ms=sw_split[0], traceback_ms=sw_split[1],
                                           scan_issue_ms=sw_split[2],
                                           traceback_issue_ms=sw_split[3], waits=sw_waits,
                                           launches=sw_launches)

    # -- state x time -------------------------------------------------------------------
    # One frame, padded to the time axis; each rank holds one (state, time) shard.
    n_time, n_state = 2, world // 2
    st_bytes, st_ol = (64, 96) if on_card else (32, 32)
    st_data, st_sym = _frames(ice, 1, st_bytes, 0, SEED + 30)
    padded, _ = pad_to_time_blocks(ice, numeric, st_sym, n_time)
    Tb = padded.shape[1] // n_time
    stmesh = Mesh({"state": n_state, "time": n_time}, device)
    tc = stmesh.axis_coords("time")[0]
    block = padded[:, tc * Tb:(tc + 1) * Tb].to(device)
    run = lambda: state_time_decode_bits(ice, numeric, block, stmesh, overlap=st_ol)  # noqa: E731
    bits, t_n = _timed(run, device)
    counted, wire = report(run)
    st_split = _phase_split(run, device) if on_card else (float("nan"),) * 4
    st_waits = (_profile(run, rank, pathlib.Path(args.out).parent / "probe_parallel_trace_st",
                         "state x time decode") if on_card else None)
    st_launches = _launches(run) if on_card else None
    parts = _gather(bits)
    if rank == 0:
        # Rank r holds (state r // n_time, time r % n_time); every state rank of a block agrees.
        got = torch.cat(parts[:n_time], dim=1)
        nbits = st_bytes * 8
        got_bytes = bits_to_bytes(got[:, ice.K - 1:ice.K - 1 + nbits])
        want, t_k = _local_timed(lambda: decode_symbols(ice, numeric, st_sym.reshape(1, -1).to(
            device), nbits, backend="cuda", device=device), device)
        inproc = Mesh({"state": n_state, "time": n_time}, device, spans_processes=False)
        same_inproc, t_1 = _local_timed(lambda: state_time_decode_bits(
            ice, numeric, padded.to(device), inproc, overlap=st_ol), device)
        agree = all(torch.equal(parts[r], parts[r % n_time]) for r in range(world))
        same = (bool(torch.equal(got_bytes, want)) and agree
                and bool(torch.equal(same_inproc, got)))
        errors = int((got_bytes.cpu().numpy() != st_data).sum())
        ok &= same and not errors
        eff = t_1 / (world * t_n)
        model = comms.state_time_model(ice, n_state, n_time, 1, padded.shape[1], overlap=st_ol)
        say(f"state x time {ice.name} one {st_bytes}-byte frame on (state={n_state}, "
            f"time={n_time}), {Tb} steps a block, overlap {st_ol}, over {world} ranks: sharded "
            f"{1e3 * t_n:.4f} ms, the same function on one card ({world} shards) "
            f"{1e3 * t_1:.4f} ms, unsharded decode on the kernels {1e3 * t_k:.4f} ms; measured "
            f"scaling efficiency {eff:.4f} (model {model['predicted_efficiency']:.4f}); bytes "
            f"equal to the unsharded decode and to the one-card run {same}, differing bytes "
            f"{errors}; collectives {counted}, {wire} wire bytes; one more run on rank 0: scans "
            f"{st_split[0]:.4f} ms (issue {st_split[2]:.4f} ms on the host clock), traceback "
            f"{st_split[1]:.4f} ms (issue {st_split[3]:.4f} ms); launches a decode "
            f"{json.dumps(st_launches)}")
        record["state_time"] = {"sharded_s": t_n, "one_card_s": t_1, "kernel_decode_s": t_k,
                                "efficiency": eff, "model": model, "equal": same,
                                "collectives": counted, "scan_ms": st_split[0],
                                "traceback_ms": st_split[1], "scan_issue_ms": st_split[2],
                                "traceback_issue_ms": st_split[3], "waits": st_waits,
                                "launches": st_launches}
        record["ok"] = bool(ok)
        if on_card:
            path = pathlib.Path(args.out)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(record, indent=1, default=str))
        print(json.dumps({"probe_parallel_ok": bool(ok)}), flush=True)
    flag = torch.tensor([int(ok) if rank == 0 else 1], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    dist.destroy_process_group()
    return 0 if int(flag) else 1


if __name__ == "__main__":
    raise SystemExit(main())
