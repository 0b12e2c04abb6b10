"""Chainback (traceback) of the survivor path: the port's portable path.

Port of ``ka9q_viterbi_comparison_tpu/ops/chainback.py``, the reference's
serial per-bit state walk (ref: ka9q_libfec_port/viterbi27_sse2.cpp:78-105).
The walk is a reverse Python loop whose per-step work is a handful of tensor
ops across the B frames:

    word  = decision_words[:, t][state >> 5]
    k     = (word >> (state & 31)) & 1
    state = (state >> 1) | (k << (K-2))          (ref: viterbi27_sse2.cpp:101-102)

``k`` at step t is decoded bit t; bytes are packed MSB-first.  Words are int32
tensors holding the uint32 pattern: ``>>`` is arithmetic on int32, but ``& 1``
after it still gives the right bit.
"""

from __future__ import annotations

import torch

from ..configs import CodeSpec
from ..utils.bits import bits_to_bytes

__all__ = ["walk", "chainback_bits", "chainback"]


def walk(
    code: CodeSpec,
    decision_words: torch.Tensor,
    endstate: torch.Tensor | int = 0,
    rotated: bool = False,
    t0: int = 0,
):
    """Reverse walk through ``decision_words [B, T, W]`` from ``endstate`` at
    the final step: ``(k [B, T] int32, start state [B] int32)``, ``k[:, t]``
    the walk output at step t.

    ``rotated``: the words are position-packed, as the in-place kernel
    writes them -- the decision for state ``s`` at step ``t`` sits at bit
    position ``rotr(s, (t + 1 + t0) mod (K-1))``, ``t0`` the global step of
    ``decision_words[:, 0]``.
    """
    B, T, W = decision_words.shape
    K = code.K
    nrot = K - 1
    mask = code.num_states - 1
    device = decision_words.device
    state = (torch.as_tensor(endstate, dtype=torch.int32, device=device) & mask).expand(B).clone()
    ks = []
    for t in range(T - 1, -1, -1):
        pos = state
        if rotated:
            rho = (t + 1 + t0) % nrot
            pos = ((state >> rho) | (state << (nrot - rho))) & mask
        word = decision_words[:, t].gather(1, (pos >> 5).long()[:, None])[:, 0]
        k = (word >> (pos & 31)) & 1
        state = (state >> 1) | (k << (K - 2))
        ks.append(k)
    if not ks:
        return torch.zeros((B, 0), dtype=torch.int32, device=device), state
    return torch.stack(ks[::-1], dim=1), state


def chainback_bits(
    code: CodeSpec,
    decision_words: torch.Tensor,
    num_data_bits: int,
    endstate: torch.Tensor | int = 0,
    rotated: bool = False,
):
    """Trace back through ``decision_words [B, T, W]`` from ``endstate`` at the
    final step, returning decoded data bits ``[B, num_data_bits]`` uint8 and
    the start state reached ``[B]`` int32.

    The first K-1 walk outputs (bits of the initial state) are dropped, the
    reference's ``d += tail`` skip (viterbi27_sse2.cpp:97).  ``rotated``:
    position-packed words from step 0 (see ``walk``).
    """
    ks, state = walk(code, decision_words, endstate, rotated)
    K = code.K
    return ks[:, K - 1 : K - 1 + num_data_bits].to(torch.uint8), state


def chainback(
    code: CodeSpec,
    decision_words: torch.Tensor,
    num_data_bits: int,
    endstate: torch.Tensor | int = 0,
    rotated: bool = False,
) -> torch.Tensor:
    """Decode to bytes ``[B, num_data_bits // 8]`` uint8 (MSB-first)."""
    if num_data_bits % 8 != 0:
        raise ValueError("num_data_bits must be a multiple of 8")
    bits, _ = chainback_bits(code, decision_words, num_data_bits, endstate, rotated)
    return bits_to_bytes(bits)
