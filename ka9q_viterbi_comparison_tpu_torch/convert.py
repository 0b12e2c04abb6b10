"""Carry the JAX package's specs and decoder state across as plain values.

The port imports nothing of ``ka9q_viterbi_comparison_tpu``; a caller who holds
objects of it passes their fields and numpy arrays here:

    code = code_from_fields(jcode.name, jcode.K, jcode.R, jcode.polys)
    numeric = numeric_from_fields(**dataclasses.asdict(jnumeric))
    dec = ViterbiDecoder(code, numeric, batch=B)
    decoder_state_from_numpy(dec, np.asarray(jdec.metrics), np.asarray(words),
                             np.asarray(jdec.renorm_offset), jdec._steps)

so that a stream started in JAX resumes in the port.  The words must come
from the same route the port decoder takes at that batch (the JAX ``pallas``
backend for the port's ``cuda`` backend, ``jnp`` for ``torch``): the in-place
route packs them in position order.
"""

from __future__ import annotations

import numpy as np
import torch

from .configs import CodeSpec, NumericSpec
from .models.decoder import ViterbiDecoder

__all__ = ["code_from_fields", "numeric_from_fields", "decoder_state_from_numpy"]


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
    words = words.astype(np.uint32, copy=False).view(np.int32)
    dev = decoder.device
    decoder.metrics = torch.from_numpy(metrics.copy()).to(dev)
    decoder.renorm_offset = torch.from_numpy(renorm_offset.copy()).to(dev)
    decoder._decision_blocks = [torch.from_numpy(words.copy()).to(dev)] if steps else []
    decoder._steps = int(steps)
    return decoder
