"""ctypes bindings for the native host decoder (``native/viterbi_host.cpp``).

The port's own copy of ``ka9q_viterbi_comparison_tpu/utils/native.py``: the
same C interface and the same Python API (``available``, ``encode``,
``decode``, ``bit_errors``, ``HostDecoder``), with its own build.  The shared
library is compiled by ``g++`` at first use into the port's ``_build/``
directory, named by a hash of the source and the flags.  The build is atomic:
under an ``fcntl`` lock on the build directory one process compiles to a
temporary name and ``os.replace``s it onto the final one, so a process never
loads a half-written library and concurrent first uses (test workers) build it
once.  A failed build raises with the compiler's output; ``available()`` is
False only where there is no ``g++``.

The flags leave out ``-march=native``: a build directory that travels with a
copy of the tree to another host must still load there.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

from ..configs import CodeSpec, NumericSpec

__all__ = ["available", "encode", "decode", "bit_errors", "HostDecoder", "library_path"]

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
SRC = PKG_DIR.parent / "native" / "viterbi_host.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {  # name -> (restype, argtypes)
    "vit_host_encode": (ctypes.c_long, [ctypes.c_int, ctypes.c_int, _I32P, _U8P, ctypes.c_long,
                                        ctypes.c_int32, ctypes.c_int32, _I32P]),
    "vit_host_decode": (ctypes.c_long, [ctypes.c_int, ctypes.c_int, _I32P, _I32P, ctypes.c_long,
                                        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_long]),
    "vit_host_bit_errors": (ctypes.c_long, [_U8P, _U8P, ctypes.c_long]),
    "vit_host_create": (ctypes.c_void_p, [ctypes.c_int, ctypes.c_int, _I32P, ctypes.c_int32,
                                          ctypes.c_int32, ctypes.c_int32, ctypes.c_long]),
    "vit_host_init": (None, [ctypes.c_void_p, ctypes.c_int]),
    "vit_host_update": (None, [ctypes.c_void_p, _I32P, ctypes.c_long]),
    "vit_host_chainback": (ctypes.c_long, [ctypes.c_void_p, _U8P, ctypes.c_long, ctypes.c_int]),
    "vit_host_delete": (None, [ctypes.c_void_p]),
}


def library_path() -> pathlib.Path:
    """Where the library of the current source and flags is (or will be)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libviterbi_host_{h.hexdigest()[:16]}.so"


def _build(lib: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "viterbi_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it while this one waited
            return
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
        if out.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SRC.name} ({out.returncode}):\n{out.stderr}")
        os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """Whether the host decoder can be used: False where there is no ``g++``;
    else the library is built (if it is not yet) and loaded, and a failed
    build raises."""
    if shutil.which("g++") is None:
        return False
    _load()
    return True


def _polys_arr(code: CodeSpec) -> np.ndarray:
    return np.asarray(code.polys, dtype=np.int32)


def encode(code: CodeSpec, numeric: NumericSpec, data: np.ndarray) -> np.ndarray:
    """Encode one frame [N] uint8 -> soft symbols [T*R] int32."""
    lib = _load()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty(code.total_symbols(len(data)), dtype=np.int32)
    polys = _polys_arr(code)
    n = lib.vit_host_encode(
        code.K, code.R, polys.ctypes.data_as(_I32P), data.ctypes.data_as(_U8P), len(data),
        numeric.soft_high, numeric.soft_low, out.ctypes.data_as(_I32P))
    if n != len(out):
        raise RuntimeError(f"native encode failed: {n}")
    return out


def decode(
    code: CodeSpec,
    numeric: NumericSpec,
    symbols: np.ndarray,
    n_bytes: int,
    starting_state: int = 0,
    endstate: int = 0,
) -> tuple[np.ndarray, int]:
    """Decode one frame of soft symbols [T*R] -> ([n_bytes] uint8, path_metric)."""
    lib = _load()
    symbols = np.ascontiguousarray(symbols, dtype=np.int32)
    out = np.zeros(n_bytes, dtype=np.uint8)
    polys = _polys_arr(code)
    pm = lib.vit_host_decode(
        code.K, code.R, polys.ctypes.data_as(_I32P), symbols.ctypes.data_as(_I32P),
        len(symbols), numeric.soft_high, numeric.soft_low, numeric.initial_margin,
        starting_state, endstate, out.ctypes.data_as(_U8P), n_bytes)
    if pm < 0:
        raise RuntimeError(f"native decode failed: {pm}")
    return out, int(pm)


class HostDecoder:
    """Stateful native decoder with the reference's 3-phase lifecycle
    (reset / update / chainback, ref: src/ka9q_interface.h:45-55), one frame
    at a time -- the ``cpu_native`` benchmark family."""

    def __init__(self, code: CodeSpec, numeric: NumericSpec, max_steps: int):
        lib = _load()
        self._lib = lib
        self.code = code
        self._polys = _polys_arr(code)
        self._h = lib.vit_host_create(
            code.K, code.R, self._polys.ctypes.data_as(_I32P), numeric.soft_high,
            numeric.soft_low, numeric.initial_margin, max_steps)
        if not self._h:
            raise RuntimeError("vit_host_create failed")

    def reset(self, starting_state: int = 0) -> None:
        self._lib.vit_host_init(self._h, starting_state)

    def update(self, symbols: np.ndarray) -> None:
        symbols = np.ascontiguousarray(symbols, dtype=np.int32)
        self._lib.vit_host_update(self._h, symbols.ctypes.data_as(_I32P), symbols.size)

    def chainback(self, n_bytes: int, endstate: int = 0) -> tuple[np.ndarray, int]:
        out = np.zeros(n_bytes, dtype=np.uint8)
        pm = self._lib.vit_host_chainback(self._h, out.ctypes.data_as(_U8P), n_bytes, endstate)
        return out, int(pm)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.vit_host_delete(h)
            self._h = None


def bit_errors(a: np.ndarray, b: np.ndarray) -> int:
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    if a.size != b.size:
        raise ValueError(f"sizes differ: {a.size} and {b.size}")
    return int(lib.vit_host_bit_errors(a.ctypes.data_as(_U8P), b.ctypes.data_as(_U8P), a.size))
