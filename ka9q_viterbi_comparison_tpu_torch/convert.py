"""Carry the JAX package's specs and decoder state across as plain values.

The port imports nothing of ``ka9q_viterbi_comparison_tpu``; a caller who holds
objects of it passes their fields and numpy arrays here:

    code = code_from_fields(jcode.name, jcode.K, jcode.R, jcode.polys)
    numeric = numeric_from_fields(**dataclasses.asdict(jnumeric))
    dec = ViterbiDecoder(code, numeric, batch=B)
    decoder_state_from_numpy(dec, np.asarray(jdec.metrics), np.asarray(words),
                             np.asarray(jdec.renorm_offset), jdec._steps)

so that a stream started in JAX resumes in the port; a ``StreamingDecoder``'s
checkpoint crosses whole through ``streaming_checkpoint_from_jax``.  The state of the JAX
package's native-layout phases (``dispatch.phase_fns``: metrics ``[S, B]``,
words ``(dec [Tp, W, B], T, B)``) crosses through ``metrics_from_numpy`` and
``native_words_from_numpy`` into the port's phases of the same family.  The words must come
from the same route the port decoder takes at that batch (the JAX ``pallas``
backend for the port's ``cuda`` backend, ``jnp`` for ``torch``): the in-place
route packs them in position order.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs import CodeSpec, NumericSpec
from .models.decoder import ViterbiDecoder, resolve_device

__all__ = ["code_from_fields", "numeric_from_fields", "decoder_state_from_numpy",
           "words_from_numpy", "tables_from_numpy", "metrics_from_numpy",
           "native_words_from_numpy", "streaming_checkpoint_from_jax"]


def code_from_fields(name: str, K: int, R: int, polys) -> CodeSpec:
    return CodeSpec(name, K=int(K), R=int(R), polys=tuple(int(p) for p in polys))


def numeric_from_fields(**fields) -> NumericSpec:
    return NumericSpec(**fields)


def decoder_state_from_numpy(decoder: ViterbiDecoder, metrics, words, renorm_offset,
                             steps: int) -> ViterbiDecoder:
    """Load a decoder's state: ``metrics [B, S]`` int32, accumulated decision
    words ``[B, T, W]`` uint32 (or int32), ``renorm_offset [B]`` int32 and the
    count of trellis steps consumed.  Returns ``decoder``."""
    B, S = decoder.batch, decoder.code.num_states
    metrics = np.asarray(metrics, dtype=np.int32)
    words = np.asarray(words)
    renorm_offset = np.asarray(renorm_offset, dtype=np.int32)
    if metrics.shape != (B, S) or renorm_offset.shape != (B,):
        raise ValueError(f"metrics {metrics.shape} / offset {renorm_offset.shape} do not "
                         f"match batch {B} and {S} states")
    if words.ndim != 3 or words.shape[0] != B or words.shape[1] != steps \
            or words.shape[2] != decoder.code.decision_words:
        raise ValueError(f"words {words.shape} do not match [B={B}, steps={steps}, "
                         f"W={decoder.code.decision_words}]")
    dev = decoder.device
    decoder.metrics = torch.from_numpy(metrics.copy()).to(dev)
    decoder.renorm_offset = torch.from_numpy(renorm_offset.copy()).to(dev)
    decoder._decision_blocks = [words_from_numpy(words, dev)] if steps else []
    decoder._steps = int(steps)
    return decoder


def words_from_numpy(words, device: torch.device | str = "cpu") -> torch.Tensor:
    """uint32 (or int32) words of any shape -> the port's int32 tensor with
    the same bits."""
    words = np.ascontiguousarray(np.asarray(words)).astype(np.uint32, copy=False).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def tables_from_numpy(tables: dict, device: torch.device | str = "cpu") -> dict:
    """The walk tables of the JAX package's ``radix_planes`` or fields
    kernels (``{"f4" | "f8" | "g2": uint32 array}``) as the port's tensors,
    for ``ops.radix_planes.chainback_planes``."""
    return {name: words_from_numpy(t, device) for name, t in tables.items()}


def metrics_from_numpy(metrics, device: torch.device | str = "cpu") -> torch.Tensor:
    """Path metrics of either layout (``[B, S]`` or the native ``[S, B]``) as
    the port's contiguous int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(metrics), dtype=np.int32).copy()).to(
        device)


def native_words_from_numpy(words_native, device: torch.device | str = "cpu"):
    """The words of a native-layout update phase, ``(dec [Tp, W, B] uint32, T,
    B)``, as the port's ``(int32 tensor, T, B)``.  The port's tracebacks take
    any ``Tp >= T``, so the JAX package's time padding stays as it is; its
    batch padding (TPU lanes) must be cut off by the caller."""
    dec, T, B = words_native
    dec = words_from_numpy(dec, device)
    if dec.ndim != 3 or dec.shape[0] < T or dec.shape[2] != B:
        raise ValueError(f"native words {tuple(dec.shape)} do not match T={T}, B={B}")
    return dec, int(T), int(B)


def streaming_checkpoint_from_jax(state: dict, device: torch.device | str = "cuda") -> dict:
    """The JAX package's ``StreamingDecoder.checkpoint()`` (arrays of any kind
    ``np.asarray`` takes: metrics ``[B, S]`` int32, history ``[B, h, W]``
    uint32) as the port's checkpoint on ``device``, for
    ``StreamingDecoder.restore``.  The packing flag crosses unchanged: both
    packages position-pack the in-place route's words alike."""
    device = resolve_device(device)
    return {
        "metrics": metrics_from_numpy(np.asarray(state["metrics"]), device),
        "history": words_from_numpy(np.asarray(state["history"]), device),
        "steps_emitted": int(state["steps_emitted"]),
        "abs_step": int(state["abs_step"]),
        "rotated_history": bool(state.get("rotated_history", False)),
    }
