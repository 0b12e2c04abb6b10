"""Backend dispatch for the CUDA kernels.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/dispatch.py`` (``acs_update``,
``_large_update``, ``chainback``, ``use_inplace``, ``supports_chainback``,
``unpack_bit_words``).  It bridges the batch-major public API (``[B, ...]``
tensors, the layout of the portable path) to the kernels' layouts.

Routes, decided on the code and the batch B alone so that update and
chainback agree:

* 5 < K <= 15 and B >= 128 (or ``KA9Q_TORCH_INPLACE=1``): the in-place
  rotating-address pair (``inplace.py``), when one block's shared memory fits
  the card.  The predicate is the JAX package's, so at the same batch both
  packages pack the same words -- except at K=15 and B > 256, where the JAX
  package leaves the in-place kernel for a TPU compiler fault
  (``ops/pallas/dispatch.py:89``) and this port does not.
* K <= 9 otherwise: the state-order pair (``kernels.py``).
* K > 9 otherwise: the state-blocked large-K pair ``acs_update_large2``
  (``large_k2.py``, its odd tail on ``large_k.py``), whose words are in
  canonical order and walk through ``chainback_tb`` up to K=15 and through
  the portable walk (``ops/chainback.py``) above, as in the JAX package.
  The JAX package sends R <= 2 codes with a state block of at least 512
  states (K=12..24 at r=1/2, ICE among them) to its depth-4 kernel
  ``acs_update_large4`` instead, which the port does not have yet; there
  the two packages agree in bytes and path metric, and the split between
  ``metrics`` and the offset may differ.

The batch is not padded: each CUDA block owns whole frames, so there is no
lane width to fill (the JAX package pads to 128 lanes only on a TPU).  Time
is padded to whole traceback words (32 steps) before the traceback, which is
the shape the Pallas traceback kernels take too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import bits_to_bytes, unpack_words_to_bits
from .. import chainback as cb
from . import flags, inplace, kernels, large_k2

__all__ = ["acs_update", "chainback", "use_inplace", "supports", "supports_chainback",
           "fits_shared", "unpack_bit_words"]

def fits_shared(code: CodeSpec, device: torch.device) -> bool:
    """Whether one in-place ACS block's shared memory fits the card of
    ``device`` (``torch.cuda.get_device_properties``; the block also needs at
    most 1024 threads, which ``acs_threads`` in the source never exceeds).
    The plain versions that serve CPU tensors have no such limit."""
    if device.type != "cuda":
        return True
    props = torch.cuda.get_device_properties(device)
    cap = getattr(props, "shared_memory_per_block_optin", props.shared_memory_per_block)
    return kernels.acs_smem_bytes(code, True) <= cap


def supports(code: CodeSpec) -> bool:
    """The state-order pair serves small trellises (K <= 9)."""
    return code.K <= 9


def supports_chainback(code: CodeSpec) -> bool:
    """The traceback kernels walk any K <= 15 (W <= 512 words a step)."""
    return code.K <= 15


def use_inplace(code: CodeSpec, batch: int, device: torch.device | str = "cpu") -> bool:
    """Route 5 < K <= 15 to the in-place pair at B >= 128, as the JAX
    package does; ``KA9Q_TORCH_INPLACE`` disables (0) or forces (1) it.

    The JAX package also refuses K=15 at B > 256 (``S * B > 16384 * 256``,
    ``ops/pallas/dispatch.py:89``), a TPU compiler fault that a card does not
    have, so here the route holds for every batch.  There the two packages
    agree in bytes and path metric, but the JAX package's large-K route
    shifts metrics into its offset where the in-place route does not."""
    mode = flags.inplace_mode()
    if mode == "off" or not (5 < code.K <= 15):
        return False
    if mode != "force" and batch < 128:
        return False
    return fits_shared(code, torch.device(device))


def unpack_bit_words(bits_words: torch.Tensor, T: int) -> torch.Tensor:
    """``[Tp//32, B]`` int32 -> trellis bits ``[B, T]`` uint8."""
    return unpack_words_to_bits(bits_words.T)[:, :T]


def _inplace_update(code, numeric, metrics, symbols, t0):
    """Batch-major wrapper over the in-place kernel.  Metrics cross the call
    in state order: one gather each way at the block edges, at the rotation
    phases ``t0`` and ``t0 + T``."""
    B, T, R = symbols.shape
    nrot = code.K - 1
    t0 = int(t0) % nrot
    dev = metrics.device
    sym = symbols.to(torch.int32).permute(1, 2, 0).contiguous()  # [T, R, B]
    m = metrics.to(torch.int32).T
    if t0:
        m = m[torch.as_tensor(inplace.rot_perm(code, t0), device=dev)]
    m, dec = inplace.acs_update_inplace(code, numeric, m.contiguous(), sym, T, t0)
    if (t0 + T) % nrot:
        m = m[torch.as_tensor(inplace.rot_perm(code, t0 + T, inverse=True), device=dev)]
    words = dec.permute(2, 0, 1)  # [B, T, W], position-packed
    return m.T.contiguous(), words, torch.zeros((B,), dtype=torch.int32, device=dev)


def _large_update(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                  symbols: torch.Tensor):
    """State-blocked large-K update: the pair kernel, two steps a launch."""
    return large_k2.acs_update_large2(code, numeric, metrics.to(torch.int32).contiguous(),
                                      symbols.to(torch.int32).contiguous())


def acs_update(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
               symbols: torch.Tensor, t0: int = 0):
    """Batch-major wrapper matching ``ops.acs.acs_update``'s contract:
    ``(metrics [B,S], symbols [B,T,R]) -> (metrics, words [B,T,W], offset)``.

    ``t0``: trellis steps already consumed (blockwise resume); only the
    in-place pair reads it.  The offset is zero on the K <= 15 whole-frame
    routes (int32 has the headroom) and the large-K route's shifts
    otherwise.
    """
    B, T, R = symbols.shape
    if use_inplace(code, B, metrics.device):
        return _inplace_update(code, numeric, metrics, symbols, t0)
    if not supports(code):
        return _large_update(code, numeric, metrics, symbols)
    sym = symbols.to(torch.int32).permute(1, 2, 0).contiguous()  # [T, R, B]
    m, dec = kernels.acs_update_tb(code, numeric, metrics.to(torch.int32).T.contiguous(),
                                   sym, T)
    offset = torch.zeros((B,), dtype=torch.int32, device=metrics.device)
    return m.T.contiguous(), dec.permute(2, 0, 1), offset


def chainback(code: CodeSpec, words: torch.Tensor, num_data_bits: int,
              endstate: int = 0) -> torch.Tensor:
    """Batch-major wrapper matching ``ops.chainback.chainback``'s contract.

    Routing mirrors ``acs_update``: words of the in-place pair are packed in
    position order and walk through ``chainback_inplace``; above K=15 the
    portable walk serves, as the JAX package's jnp walk does."""
    if num_data_bits % 8 != 0:
        raise ValueError("num_data_bits must be a multiple of 8")
    B, T, W = words.shape
    if not supports_chainback(code):
        return cb.chainback(code, words, num_data_bits, endstate)
    inplace_route = use_inplace(code, B, words.device)
    Tp = inplace.pad_time_inplace(code, T)
    w = F.pad(words.to(torch.int32).permute(1, 2, 0), (0, 0, 0, 0, 0, Tp - T)).contiguous()
    end = torch.full((1, B), endstate & (code.num_states - 1), dtype=torch.int32,
                     device=words.device)
    walk = inplace.chainback_inplace if inplace_route else kernels.chainback_tb
    bits = unpack_bit_words(walk(code, w, end, T), T)
    return bits_to_bytes(bits[:, code.K - 1 : code.K - 1 + num_data_bits])
