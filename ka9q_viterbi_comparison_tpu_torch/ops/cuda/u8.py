"""The ka9q- and SPIRAL-exact u8 replicas' update on the card.

The JAX package writes both replicas (``ops/quantized.py``
``quantized_update``, ``spiral_update``) as one ``jax.jit`` over one
``lax.scan``, so this kernel replaces no Pallas kernel; it takes the port's
replicas off the host, where each trellis step was a round of PyTorch
launches.  ``u8_warp_kernel<K, SPIRAL>`` (``csrc/viterbi_u8.cu``; counters
``quantized_update`` and ``spiral_update``): a warp a frame, the metrics in
registers in state order, the predecessors by shuffles from the lanes of
``lane_table``, each step's canonical words the ballots of its registers.
Rate 1/2, K = 2..9.  Its plain version is ``ops/quantized.py``
``_u8_update``, which also picks the route (this module only launches).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...configs import CodeSpec
from . import _build

__all__ = ["MAX_K", "lane_table", "launch_u8"]

MAX_K = 9      # the kernel's largest trellis (u8_dispatch in the source)
STAGE = 32     # steps a stage (kU8Stage): rows past T are at most STAGE - 1


def lane_table(code: CodeSpec, tables) -> np.ndarray:
    """``[max(S, 32)]`` int32, the kernel's per-(lane, register) constants,
    entry ``n = 32*r + lane`` for new state ``s = n % S`` (below 32 states
    the lanes past ``S`` compute copies): bits 0-1 the branch pattern
    ``(bt0[s2] & 1) | (bt1[s2] & 1) << 1`` of its butterfly ``s2 = s >> 1``
    in the rail ``tables`` (``[2, S/2]``, each entry 0 or 255), bit 2 the
    butterfly bit ``b = s & 1``, byte 2 the lane of the low predecessor
    ``s2``, byte 3 the lane of the high one ``s2 + S/2``."""
    S = code.num_states
    bt = np.asarray(tables, dtype=np.int64)
    s = np.arange(max(S, 32), dtype=np.int64) % S
    s2 = s >> 1
    pattern = (bt[0, s2] & 1) | ((bt[1, s2] & 1) << 1)
    out = pattern | ((s & 1) << 2) | ((s2 % 32) << 16) | (((s2 + S // 2) % 32) << 24)
    return out.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def _device_lane_table(code: CodeSpec, tables: tuple, device: torch.device) -> torch.Tensor:
    """``lane_table`` on ``device``, uploaded once per code, family and device."""
    return torch.as_tensor(lane_table(code, tables), device=device)


def launch_u8(code: CodeSpec, tables: tuple, metrics: torch.Tensor, symbols: torch.Tensor,
              Tp: int, threshold: int, spiral: bool):
    """Launch one update over ``symbols [B, T, 2]`` uint8 from ``metrics
    [B, S]`` uint8 (any strides, read where they lie): ``(metrics [B, S]
    uint8, words [Tp, W, B] int32)``, words past ``T`` zero.  Counted as
    ``spiral_update`` or ``quantized_update`` by ``spiral``."""
    counter = "spiral_update" if spiral else "quantized_update"
    B, S = metrics.shape
    T = symbols.shape[1]
    if not 2 <= code.K <= MAX_K or code.R != 2:
        raise ValueError(f"{counter}: the u8 kernel takes rate-1/2 codes of K = 2..{MAX_K}, "
                         f"got K={code.K} R={code.R}")
    for name, t, shape in (("metrics", metrics, (B, code.num_states)),
                           ("symbols", symbols, (B, T, 2))):
        if not t.is_cuda or t.device != metrics.device:
            raise ValueError(f"{counter}: {name} must lie on {metrics.device}, got {t.device}")
        if t.dtype != torch.uint8:
            raise ValueError(f"{counter}: {name} must be uint8, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{counter}: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not T <= Tp < T + STAGE:
        raise ValueError(f"{counter}: Tp={Tp} outside [{T}, {T + STAGE})")
    dev = metrics.device
    m_out = torch.empty((B, S), dtype=torch.uint8, device=dev)
    words = torch.empty((Tp, code.decision_words, B), dtype=torch.int32, device=dev)
    _build.launch(counter, "viterbi_u8", dev, metrics.data_ptr(), *metrics.stride(),
                  symbols.data_ptr(), *symbols.stride(),
                  _device_lane_table(code, tables, dev).data_ptr(), m_out.data_ptr(),
                  words.data_ptr(), code.K, int(spiral), int(threshold), B, T, Tp)
    return m_out, words
