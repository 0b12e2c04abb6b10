"""ka9q-exact and SPIRAL-exact u8 decoding (the quantized-metric modes).

Port of ``ka9q_viterbi_comparison_tpu/ops/quantized.py``.  The main paths
accumulate branch metrics int32-exact, which is cleaner than the reference
decoders' u8 pipelines; on noisy symbols those can decide differently near
ties.  These replicas reproduce the u8 arithmetic exactly, so that the
decoded bytes equal the reference binaries' on any symbol stream.

ka9q (``quantized_update``, ref: ka9q_libfec_port/viterbi27_sse2.cpp):

* branch table ``parity((2*s2) & poly) ? 255 : 0`` (``:64-69``);
* branch metric ``(bt0^sym0 avg bt1^sym1) >> 4`` with SSE's rounding average
  ``(a + b + 1) >> 1`` (``:137-144``), complement ``15 - m``;
* path metrics u8 with modulo-256 adds (a ``torch.uint8`` add wraps), no
  renormalisation (``:148-151``);
* survivor select by the sign of the wrapped difference,
  ``(m0 - m1).view(torch.int8) > 0``: ties to the LOW predecessor
  (``:154-156``).

SPIRAL (``spiral_update``, ref: spiral/spiral27.cpp:130-254): metric
``avg >> 2`` (0..63), complement ``63 - m``, SATURATING u8 adds (a widen and a
clamp), ``min`` select with ties to the HIGH predecessor, and per step, when
metric[0] > 210, the frame's minimum subtracted from every metric.

The JAX package writes both in jnp with no Pallas kernel.  The route is
chosen by device and K (``_on_kernel``): on a CUDA device at K <= 9 one
launch of ``u8_warp_kernel`` (``csrc/viterbi_u8.cu`` via ``ops/cuda/u8.py``)
an update, which raises if it fails to build or launch; on the CPU the plain
version ``_u8_update``, one trellis step a loop iteration; on a CUDA device
at K >= 10 that same loop, on purpose: no reference binary runs a u8
rate-1/2 replica there, and the kernel's registers hold 256 states at most.
Decisions are packed canonically (bit ``s % 32`` of word ``s // 32``) and
the decode walks them through the ``chainback_tb`` traceback kernel (its
plain version on a CPU device), never through ``dispatch.chainback``, which
would walk the in-place route's position packing at B >= 128.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import CodeSpec
from ..models.decoder import resolve_device
from ..utils.bits import pack_bits_to_words
from .cuda import dispatch, inplace, kernels, u8

__all__ = ["ka9q_branch_tables", "quantized_update", "init_metrics_u8", "decode_symbols_ka9q",
           "SPIRAL_RENORM_THRESHOLD", "spiral_update", "decode_symbols_spiral"]

SPIRAL_RENORM_THRESHOLD = 210  # the generated literal in spiral27/29 (spiral27.cpp:236)
_CHUNK = 256  # trellis steps whose branch metrics and decisions are built at once


def _parity64(x: np.ndarray) -> np.ndarray:
    for shift in (32, 16, 8, 4, 2, 1):
        x = x ^ (x >> shift)
    return x & 1


@functools.lru_cache(maxsize=8)
def ka9q_branch_tables(code: CodeSpec) -> tuple:
    """``[R, S/2]`` uint8 rail tables: ``parity((2*s2) & poly_r) ? 255 : 0``
    (ref: viterbi27_sse2.cpp:64-69).  Every polynomial must tap both register
    ends (bit 0 and bit K-1), the structure ka9q's metric/complement pairing
    assumes."""
    if code.R != 2:
        raise ValueError("ka9q u8 quantized mode covers the rate-1/2 codes")
    for p in code.abs_polys():
        if not (p & 1) or not ((p >> (code.K - 1)) & 1):
            raise ValueError(
                "ka9q's metric-complement pairing needs every polynomial "
                "to tap both register ends")
    s2 = np.arange(code.num_states // 2, dtype=np.int64)
    bt = np.stack([(_parity64((2 * s2) & p) * 255).astype(np.uint8) for p in code.abs_polys()])
    return tuple(map(tuple, bt))


@functools.lru_cache(maxsize=8)
def _spiral_branch_tables(code: CodeSpec) -> tuple:
    """``(poly < 0) ^ parity((2*s2) & |poly|) ? 255 : 0``
    (ref: spiral/spiral27.cpp:67-71; the negative-poly inversion)."""
    if code.R != 2:
        raise ValueError("spiral u8 quantized mode covers the rate-1/2 codes")
    s2 = np.arange(code.num_states // 2, dtype=np.int64)
    bt = np.stack([((_parity64((2 * s2) & p) ^ (1 if inv else 0)) * 255).astype(np.uint8)
                   for p, inv in zip(code.abs_polys(), code.inversions())])
    return tuple(map(tuple, bt))


def init_metrics_u8(code: CodeSpec, batch: int, starting_state: int = 0,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """ka9q init: every metric 63, the start state biased to 0
    (ref: viterbi27_sse2.cpp:42-53)."""
    m = torch.full((batch, code.num_states), 63, dtype=torch.uint8,
                   device=resolve_device(device))
    m[:, starting_state & (code.num_states - 1)] = 0
    return m


def _branch_pairs(tables, symbols: torch.Tensor, shift: int, top: int):
    """Per step the metric pair of each butterfly for the two inputs, as
    ``[T, B, S/2, 2]`` uint8: ``(m, top - m)`` added to the LOW predecessor
    and ``(top - m, m)`` to the HIGH one, ``m = (bt0^sym0 avg bt1^sym1) >>
    shift``."""
    bt = torch.as_tensor(np.asarray(tables, dtype=np.uint8), device=symbols.device)
    x0 = bt[0] ^ symbols[:, :, 0, None]  # [T, B, S/2] (symbols [T, B, 2])
    x1 = bt[1] ^ symbols[:, :, 1, None]
    met = (((x0.to(torch.int16) + x1.to(torch.int16) + 1) >> 1) >> shift).to(torch.uint8)
    comp = top - met
    return torch.stack([met, comp], dim=-1), torch.stack([comp, met], dim=-1)


def _u8_update(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor, spiral: bool):
    """The shared time loop: ``(metrics [B, S] uint8, words [Tp, W, B] int32)``
    with the time padded to whole traceback words (zero words past T)."""
    B, S = metrics.shape
    T = symbols.shape[1]
    S2 = S // 2
    W = code.decision_words
    sym = symbols.to(device=metrics.device, dtype=torch.uint8).permute(1, 0, 2)  # [T, B, 2]
    words = torch.zeros((inplace.pad_time_inplace(code, T), W, B), dtype=torch.int32,
                        device=metrics.device)
    tables = _spiral_branch_tables(code) if spiral else ka9q_branch_tables(code)
    # SPIRAL's saturating adds run on int16 metrics (0..255); ka9q's wrap in uint8.
    m = metrics.to(torch.int16 if spiral else torch.uint8)
    for lo_t in range(0, T, _CHUNK):
        hi_t = min(lo_t + _CHUNK, T)
        to_lo, to_hi = _branch_pairs(tables, sym[lo_t:hi_t], 2 if spiral else 4,
                                     63 if spiral else 15)
        if spiral:
            to_lo, to_hi = to_lo.to(torch.int16), to_hi.to(torch.int16)
        decs = torch.empty((hi_t - lo_t, B, S), dtype=torch.bool, device=m.device)
        for j in range(hi_t - lo_t):
            c_lo = m[:, :S2, None] + to_lo[j]  # [B, S/2, 2]: new states 2*s2 + b
            c_hi = m[:, S2:, None] + to_hi[j]
            d = decs[j].view(B, S2, 2)
            if spiral:
                c_lo.clamp_(max=255)
                c_hi.clamp_(max=255)
                torch.le(c_hi, c_lo, out=d)  # ties: the HIGH predecessor
                m = torch.minimum(c_lo, c_hi).reshape(B, S)
                mn = m.amin(dim=-1, keepdim=True)
                m = torch.where(m[:, :1] > SPIRAL_RENORM_THRESHOLD, m - mn, m)
            else:
                torch.gt((c_lo - c_hi).view(torch.int8), 0, out=d)  # ties: the LOW predecessor
                m = torch.where(d, c_hi, c_lo).reshape(B, S)
        if S < 32:
            decs = torch.nn.functional.pad(decs, (0, 32 - S))
        words[lo_t:hi_t] = pack_bits_to_words(decs).permute(0, 2, 1)
    return m.to(torch.uint8), words


def _on_kernel(code: CodeSpec, device: torch.device) -> bool:
    """Whether an update on ``device`` launches the u8 kernel: on a CUDA
    device at K <= 9 (``u8.MAX_K``); elsewhere the plain loop runs."""
    return device.type == "cuda" and code.K <= u8.MAX_K


def _update(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor, spiral: bool):
    """One update by the route of ``_on_kernel``: ``(metrics [B, S] uint8,
    words [Tp, W, B] int32)``, as ``_u8_update``."""
    if not _on_kernel(code, metrics.device):
        return _u8_update(code, metrics, symbols, spiral)
    tables = _spiral_branch_tables(code) if spiral else ka9q_branch_tables(code)
    sym = symbols.to(device=metrics.device, dtype=torch.uint8)
    return u8.launch_u8(code, tables, metrics.to(torch.uint8), sym,
                        inplace.pad_time_inplace(code, sym.shape[1]), SPIRAL_RENORM_THRESHOLD, spiral)


def quantized_update(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor):
    """ka9q-exact u8 symbol update.

    ``metrics`` ``[B, S]`` uint8 (modulo-256 path metrics), ``symbols``
    ``[B, T, 2]`` u8 offset-binary.  Returns ``(metrics [B, S] uint8, words
    [B, T, W] int32)``, the decisions in the canonical packed layout."""
    T = symbols.shape[1]
    m, words = _update(code, metrics, symbols, spiral=False)
    return m, words[:T].permute(2, 0, 1)


def spiral_update(code: CodeSpec, metrics: torch.Tensor, symbols: torch.Tensor):
    """SPIRAL-exact u8 saturating symbol update (spiral27/spiral29); returns
    ``(metrics, words)`` as :func:`quantized_update`.  The renormalisation
    threshold is ``SPIRAL_RENORM_THRESHOLD`` as it reads at the call."""
    T = symbols.shape[1]
    m, words = _update(code, metrics, symbols, spiral=True)
    return m, words[:T].permute(2, 0, 1)


def _decode_u8(code, symbols, num_data_bits, endstate, device, spiral):
    device = resolve_device(device)
    if isinstance(symbols, np.ndarray):
        symbols = torch.from_numpy(symbols)
    symbols = symbols.to(device=device, dtype=torch.uint8).reshape(symbols.shape[0], -1, code.R)
    B, T = symbols.shape[:2]
    _, words = _update(code, init_metrics_u8(code, B, device=device), symbols, spiral)
    return dispatch.walk_bytes(code, kernels.chainback_tb, words, T, num_data_bits, endstate)


def decode_symbols_ka9q(code: CodeSpec, symbols, num_data_bits: int, endstate: int = 0,
                        device: torch.device | str = "cuda") -> torch.Tensor:
    """Full ka9q-exact lifecycle over u8 offset-binary symbols ``[B, T*R]``
    (or ``[B, T, R]``); returns decoded bytes ``[B, num_data_bits // 8]``."""
    return _decode_u8(code, symbols, num_data_bits, endstate, device, spiral=False)


def decode_symbols_spiral(code: CodeSpec, symbols, num_data_bits: int, endstate: int = 0,
                          device: torch.device | str = "cuda") -> torch.Tensor:
    """SPIRAL-exact decode of u8 offset-binary symbols ``[B, T*R]``."""
    return _decode_u8(code, symbols, num_data_bits, endstate, device, spiral=True)
