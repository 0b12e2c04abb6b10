"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into
shared libraries with a plain C interface and loaded with ``ctypes``: one
``nvcc`` per source, all started together.  The build runs at first use,
never at import, and is cached under ``_build/`` inside the package by a
hash of the sources and flags, so a second process loads the libraries
without compiling.

Every wrapper counts its launches in ``LAUNCHES``; a run can zero the counts
(``reset_launch_counts``) and read them after to show which kernels it went
through.  Under a profiler each launcher call is also a ``ka9q.launch.<key>``
span (``utils.spans``), named by the same key.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

from ...utils.spans import span

__all__ = ["LAUNCHES", "FORM_LAUNCHES", "WALK_SEGMENTS", "reset_launch_counts", "library", "library_paths", "build_seconds", "launch",
           "Bound", "check_cuda_int32"]

PKG_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("viterbi_small.cu", "viterbi_large.cu", "viterbi_large4.cu", "viterbi_walk.cu",
           "viterbi_u8.cu", "viterbi_shard.cu")
HEADERS = ("viterbi_large.cuh",)  # included by the sources; part of the cache key
# -split-compile 0: the optimiser works on a source's kernels in parallel, on
# all cores (viterbi_small.cu instantiates some forty).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile", "0", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: dict[str, int] = {
    "acs_update_tb": 0,
    "acs_update_tb2": 0,
    "chainback_tb": 0,
    "acs_update_inplace": 0,
    "chainback_inplace": 0,
    "acs_update_large2": 0,
    "acs_update_large": 0,
    "acs_update_large4": 0,
    "acs_update_large4_fields": 0,
    "acs_update_large4_fields8": 0,
    "chainback_planes": 0,
    "quantized_update": 0,
    "spiral_update": 0,
    "sharded_acs_scan": 0,
    "sharded_traceback": 0,
    "sharded_traceback_step": 0,
}

# The tracebacks' launches by output form ("chainback_tb:bytes", ...): a
# tally beside the counters, which reset_launch_counts leaves alone.
FORM_LAUNCHES: dict[str, int] = {}

# The staged walk's segments launched (B x n a launch, from kernels.walk_plan);
# kernels.rewalk_stats reads it beside the kernel's count of those walked again.
WALK_SEGMENTS: dict[str, int] = {"launched": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PI = ctypes.POINTER(ctypes.c_int)
# extern "C" entry points of the sources: name -> argtypes.
_SIGNATURES = {
    # The whole-frame ACS launchers: entry metrics and their (s, b) strides,
    # symbols and their (t, r, b) strides, the tables, exit metrics and their
    # strides, the words, then the scalars (kernels.acs_launch_args).
    "viterbi_acs_tb": (_P, _L, _L, _P, _L, _L, _L, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I,
                       _I, _I, _P),
    "viterbi_acs_tb2": (_P, _L, _L, _P, _L, _L, _L, _P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P),
    "viterbi_acs_tb_smem": (_I, _I, _I),
    "viterbi_acs_inplace": (_P, _L, _L, _P, _L, _L, _L, _P, _P, _P, _P, _L, _L, _P, _I, _I, _I,
                            _I, _I, _I, _I, _I, _P),
    "viterbi_acs_inplace_smem": (_I, _I, _I),
    "viterbi_chainback": (_I, _P, _L, _L, _L, _I, _I, _P, _L, _P, _L, _L, _I, _P, _I, _P, _L,
                          _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    "viterbi_acs_large": (_I, _P, _P, _PI, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _P),
    "viterbi_acs_large2_chip": (_P, _P, _PI, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _L, _L, _L, _L, _P),
    "viterbi_acs_large4": (_I, _P, _P, _PI, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _P),
    "viterbi_plane_walk": (_P, _P, _P, _P, _L, _L, _P, _I, _L, _I, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _P),
    "viterbi_chase": (_P, _I, _P, _P),
    "viterbi_u8": (_P, _L, _L, _P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "viterbi_shard_step": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _L,
                           _PI, _P),
    "viterbi_shard_walk": (_P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "viterbi_shard_walk_step": (_P, _L, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}

_build_seconds: list[float] = []


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(put nvcc on PATH or set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_paths() -> list[pathlib.Path]:
    """Where the shared library of each source is (or will be) cached."""
    return [BUILD_DIR / f"lib{pathlib.Path(src).stem}_{_source_hash()}.so" for src in SOURCES]


@functools.lru_cache(maxsize=None)
def library() -> dict[str, ctypes._CFuncPtr]:
    """Compile (if not cached) and load the kernel libraries; returns the
    extern "C" launchers by name."""
    sos = library_paths()
    if not all(so.exists() for so in sos):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmps = [so.with_suffix(f".{os.getpid()}.tmp") for so in sos]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, tmp in zip(SOURCES, tmps)]
        errs = [proc.communicate()[1] for proc in procs]
        failed = [f"{src} ({proc.returncode}):\n{err}"
                  for src, proc, err in zip(SOURCES, procs, errs) if proc.returncode]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for tmp, so in zip(tmps, sos):
            os.replace(tmp, so)  # atomic: a concurrent build never sees a partial file
        _build_seconds.append(time.perf_counter() - t0)
    libs = [ctypes.CDLL(str(so)) for so in sos]
    fns = {}
    for name, argtypes in _SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def build_seconds() -> float:
    """Seconds this process spent in nvcc (0.0 when the cache was warm)."""
    return sum(_build_seconds)


def check_cuda_int32(name: str, t: torch.Tensor, shape: tuple, contiguous: bool = True) -> None:
    """Refuse what a launcher cannot take: a tensor off the card, of another
    dtype or shape, or (``contiguous``) one that is not contiguous.  With
    ``contiguous=False`` any strides pass: the kernel reads them."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: expected int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(counter: str, fn_name: str, device: torch.device, *args) -> None:
    """Call one extern "C" launcher on the device's current stream; raise on
    a non-zero CUDA error code; count the launch."""
    with torch.cuda.device(device):
        Bound(counter, fn_name, device)(*args)


class Bound:
    """One extern "C" launcher resolved once, for repeated calls: the library
    function and the device's current stream at binding.  ``bound(*args)``
    calls it on that stream, raises on a non-zero CUDA error code and adds
    the kernel launches the call made to ``counter``: one, or, where the
    launcher reports them through an ``int*`` argument, the value it wrote
    to ``reported`` (the caller passes ``ctypes.pointer(reported)``).  The
    call is the span ``ka9q.launch.<counter>``.  The caller makes the calls
    with ``device`` current."""

    def __init__(self, counter: str, fn_name: str, device: torch.device,
                 reported: ctypes.c_int | None = None):
        self.fn_name, self.counter, self.reported = fn_name, counter, reported
        self.span_name = f"ka9q.launch.{counter}"
        self.fn = library()[fn_name]
        self.stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def __call__(self, *args) -> None:
        with span(self.span_name):
            err = self.fn(*args, self.stream)
        if err != 0:
            raise RuntimeError(f"{self.fn_name}: CUDA error {err} at launch")
        LAUNCHES[self.counter] += 1 if self.reported is None else self.reported.value
