"""One run of one cell: set-up, the measured window, the traced stretch,
and the comparison with the plain reference once the window has closed.

The window is a closed loop: one caller keeps ``inflight`` calls queued,
issuing call n+1 before it waits for call n, as a receiver that
double-buffers does.  Outputs stay on the device.  A call's gap is read on
the device's clock: from the event recorded after the call before it to the
event recorded after its own last operation.  Every metric, end to end or
per layer, is read from the run's ``Context`` by its own file under
``perfbench/metrics/``."""

from __future__ import annotations

import collections
import gc
import sys
import time

import numpy as np
import torch

from . import entries
from . import spec as spec_mod
from .trace import profile

__all__ = ["run", "Context", "Reservoir", "FORBIDDEN", "SAMPLE", "TRACE_CALLS", "TRACE_AFTER_S"]

# Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "ka9q_viterbi_comparison_tpu")
# Calls of the window kept for the comparison (besides the last one).
SAMPLE = 16
# The traced stretch of a ``--trace 1`` run: its calls, and when it starts.
TRACE_CALLS = 200
TRACE_AFTER_S = 2.0


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, {}
        self._slots: list = []

    def offer(self, key, value) -> None:
        if len(self._slots) < self.k:
            self._slots.append(key)
            self.items[key] = value
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                del self.items[self._slots[j]]
                self._slots[j] = key
                self.items[key] = value
        self.seen += 1


class _DeviceClock:
    def __init__(self, device):
        self.device = device

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, ev):
        ev.synchronize()

    def span_ms(self, a, b) -> float:
        return a.elapsed_time(b)

    def sync(self):
        torch.cuda.synchronize(self.device)


class _HostClock:
    """Stands in for the device's clock where the run drives the CPU (the
    tests); its spans are host times and are never reported."""

    def mark(self):
        return time.perf_counter()

    def wait(self, ev):
        pass

    def span_ms(self, a, b) -> float:
        return (b - a) * 1e3

    def sync(self):
        pass


class Context:
    """What a metric's reader gets: the cell's files; the window's length,
    the bits its calls released, the device's gaps between calls and the set-up
    time; the trace of the traced stretch and its call count, the host's issue
    times of the window's other calls, and the least time of each kernel's work
    a call."""

    def __init__(self, spec, *, window_s=0.0, bits=0, gaps_ms=(), setup_s=0.0, trace=None,
                 traced_calls=0, issue_s=(), bounds=None):
        self.spec, self.window_s, self.bits, self.gaps_ms = spec, window_s, bits, list(gaps_ms)
        self.setup_s, self.trace, self.traced_calls = setup_s, trace, traced_calls
        self.issue_s, self.bounds = list(issue_s), bounds or {}

    def kernel_s_per_call(self, role: str) -> float | None:
        """Mean device seconds a call of the kernels the cell's file names for
        ``role`` (``acs``, ``walk``); None where the trace has none."""
        if self.trace is None or not self.traced_calls:
            return None
        t = self.trace.time_us(self.spec.kernels[f"{role}_kernel"])
        return t * 1e-6 / self.traced_calls if t > 0 else None


def _window(entry, traffic, seconds, clock, trace, rng, start, max_calls):
    inflight = int(traffic["inflight"])
    pending = collections.deque()
    state = {"prev": clock.mark(), "gaps": [], "traced": None}
    issue_s, res = [], Reservoir(SAMPLE, rng)
    bits, last, n = 0, None, start

    def retire():
        ev = pending.popleft()
        clock.wait(ev)
        state["gaps"].append(clock.span_ms(state["prev"], ev))
        state["prev"] = ev

    def issue():
        nonlocal bits, last, n
        t0 = time.perf_counter()
        out = entry.call(n)
        issue_s.append(time.perf_counter() - t0)
        pending.append(clock.mark())
        bits += entry.bits(out)
        kept = entry.keep(out)
        res.offer(n, kept)
        last = (n, kept)
        n += 1
        if len(pending) >= inflight:
            retire()

    t_start = time.perf_counter()
    traced_range = None
    while True:
        elapsed = time.perf_counter() - t_start
        if elapsed >= seconds or (max_calls is not None and n - start >= max_calls):
            break
        if trace and traced_range is None and elapsed >= TRACE_AFTER_S:
            while pending:
                retire()
            k0, got = len(issue_s), {}
            with profile(got):
                for _ in range(TRACE_CALLS):
                    issue()
                while pending:
                    retire()
            state["traced"] = got["trace"]
            traced_range = (k0, len(issue_s))
            continue
        issue()
    while pending:
        retire()
    window_s = time.perf_counter() - t_start
    kept = dict(res.items)
    kept[last[0]] = last[1]
    return {"window_s": window_s, "bits": bits, "gaps_ms": state["gaps"], "issue_s": issue_s,
            "kept": kept, "last": last[0], "trace": state["traced"],
            "traced_range": traced_range, "calls": n - start}


def run(spec: spec_mod.Spec, seed: int, seconds: float, trace: bool, device: torch.device,
        t_begin: float, program=None, max_calls: int | None = None, log=None) -> dict:
    """One run; returns the result line's object (``checks`` last).
    ``program`` replaces the port (the control); ``max_calls`` ends the
    window early (the control and the tests)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_run = time.perf_counter()
    clock = _DeviceClock(device) if device.type == "cuda" else _HostClock()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)  # the context
    t_ctx = time.perf_counter()
    entry = entries.load(spec.traffic["entry"]).Entry(spec.config, spec.traffic, seed, device,
                                                      program)
    clock.sync()
    t_entry = time.perf_counter()
    for k in range(entry.warmup):
        entry.call(k)
    clock.sync()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_begin
    log(f"set-up {setup_s:.3f} s: start and imports {t_run - t_begin:.3f}, context "
        f"{t_ctx - t_run:.3f}, inputs and program {t_entry - t_ctx:.3f}, warm-up "
        f"{t_warm - t_entry:.3f} ({entry.warmup} calls)")
    gc.collect()
    gc.freeze()
    win = _window(entry, spec.traffic, seconds, clock, trace, np.random.default_rng(seed),
                  entry.warmup, max_calls)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    final = entry.finish(win["last"])
    entry.program = None  # the program's state goes before the reference runs
    t_ref = time.perf_counter()
    checks, failed, info = entry.check(win["kept"], final)
    ref_s = time.perf_counter() - t_ref
    log(f"cell {spec.name} seed {seed}: {win['calls']} calls in {win['window_s']:.3f} s, "
        f"reference {ref_s:.3f} s, {info}")
    if win["gaps_ms"]:
        g = np.asarray(win["gaps_ms"])
        med = float(np.median(g))
        log(f"gaps ms: median {med:.6f}, mean {g.mean():.6f}, p95 {np.percentile(g, 95):.6f}, "
            f"max {g.max():.6f}; over 1.5 x median {int((g > 1.5 * med).sum())}, their excess "
            f"{float((g[g > 1.5 * med] - med).sum()):.3f} ms")

    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": spec.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": not any(checks.values()), "attempted": win["calls"], "failed": failed}
    tr, (k0, k1) = win["trace"], win["traced_range"] or (0, 0)
    ctx = Context(spec, window_s=win["window_s"], bits=win["bits"], gaps_ms=win["gaps_ms"],
                  setup_s=setup_s, trace=tr, traced_calls=k1 - k0,
                  issue_s=win["issue_s"][:k0] + win["issue_s"][k1:], bounds=entry.bounds())
    metrics = {}
    for m in spec.per_layer if trace else spec.end_to_end:
        value = spec_mod.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and tr is not None and tr.ops:
        device_info["busy_s"] = tr.busy_us() * 1e-6
        device_info["window_s"] = tr.window_us() * 1e-6
        out["breakdown"] = {"device_ops": [list(x) for x in tr.by_name()[:10]],
                            "idle_gaps": [list(x) for x in tr.gaps(10)]}
    out["metrics"] = metrics
    out["device"] = device_info
    out["checks"] = {name: {"value": value, "limit": 0} for name, value in checks.items()}
    return out
