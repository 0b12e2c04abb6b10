"""Depth-2 state-order ACS: two trellis steps a loop pass.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/kernels2.py``
(``acs_update_tb2``), a drop-in for ``kernels.acs_update_tb`` with the same
contract: metrics ``[S, B]`` int32 in and out, symbols ``[Tp, R, B]``,
canonical decision words ``[Tp, W, B]`` (bit ``s % 32`` of word ``s // 32``),
steps past ``t_real`` never run, no renormalisation.  The CUDA kernels are
in ``csrc/viterbi_small.cu``: for K <= 9 the state-order warp form that also
serves ``acs_update_tb`` (``acs_tb_warp_kernel``, one step a pass: in its
layout two steps a pass would cost more instructions a step, not fewer;
``PERF.md`` §6), for K = 10..13, which no route sends here,
``acs_tb2_block_kernel``.  This wrapper keeps its own launch counter; beside
it is its plain PyTorch version.  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.

What a pair computes.  Step A's new state ``i = 2*s2 + b1`` stays in raw
butterfly coordinates ``(b1, s2)``.  Step B pairs ``i`` with ``i + S/2``,
which in those coordinates is ``s2`` with ``s2 + S/4`` of the same ``b1``, so
it is elementwise between the halves of each candidate array; its penalties
are those of pair entry ``2*s2 + b1``; its new states are ``4*s2 + 2*b1 +
b2``.  An odd ``t_real`` ends with one step A alone.  Both steps' decision
words are written per step in canonical order, so the traceback is the one of
``kernels.py``.

Depth 2 needs four predecessors a thread, so K >= 3; the block form holds
S/4 threads, so K <= 13.  Outside that range the wrapper raises: it never
gives way to ``acs_update_tb`` on its own.
"""

from __future__ import annotations

import torch

from ...configs import CodeSpec, NumericSpec
from ..acs import _pack_decisions
from ..branch import transition_tables
from .kernels import _check_t_real, _into, acs_smem_bytes, launch_acs_tb, metrics_like

__all__ = ["acs_update_tb2", "acs_update_tb2_ref", "tb2_smem_bytes"]


def _check_code(code: CodeSpec) -> None:
    """3 <= K <= 13 (the dispatch routes only K <= 9 here)."""
    if not 3 <= code.K <= 13:
        raise ValueError(f"{code.name}: the depth-2 ACS serves 3 <= K <= 13, got K={code.K}")


def tb2_smem_bytes(code: CodeSpec) -> int:
    """Dynamic shared memory of one block: the warp form's for K <= 9
    (``kernels.acs_smem_bytes``); above, two metric buffers and the staged
    symbols (the block form keeps its table entries in registers)."""
    return acs_smem_bytes(code, depth=2)


def _butterfly(lo: torch.Tensor, hi: torch.Tensor, pen: torch.Tensor):
    """``lo, hi [n, B]``, ``pen [4, n, B]`` (index ``h*2 + b``): candidates
    and decisions ``[2, n, B]`` by input bit.  Ties keep ``lo``."""
    c_lo = lo + pen[:2]
    c_hi = hi + pen[2:]
    d = c_hi < c_lo
    return torch.where(d, c_hi, c_lo), d


def acs_update_tb2_ref(code: CodeSpec, numeric: NumericSpec, metrics_sb: torch.Tensor,
                       symbols_trb: torch.Tensor, t_real: int, out: torch.Tensor | None = None):
    """Plain version of ``acs_update_tb2`` (words past ``t_real`` are zero;
    inputs of any strides, exit metrics in ``kernels.metrics_like``): the
    same pairs in raw butterfly coordinates, written with tensor operations
    over ``[.., B]``."""
    _check_code(code)
    S, B = metrics_sb.shape
    Tp = symbols_trb.shape[0]
    t_real = _check_t_real(t_real, Tp)
    dev = metrics_sb.device
    S2, S4, W = S // 2, S // 4, code.decision_words
    e = torch.as_tensor(transition_tables(code), device=dev).to(torch.int32)  # [4, R, S2]
    # e2[b1][x, r, s2] = e[x, r, 2*s2 + b1]: step B's table in raw coordinates.
    e2 = [e[:, :, b1::2] for b1 in (0, 1)]
    sym = symbols_trb[:t_real].to(torch.int32)
    base = (sym - numeric.soft_low).sum(dim=1, dtype=torch.int32)  # [t, B]
    coef = (numeric.soft_high + numeric.soft_low) - 2 * sym         # [t, R, B]

    def pens(table, t):  # [4, R, n] -> [4, n, B]
        return base[t] + (table[:, :, :, None] * coef[t][None, :, None, :]).sum(dim=1)

    def words(d_sb):  # decisions [S, B] bool in state order -> [W, B]
        return _pack_decisions(d_sb.T).T

    m = metrics_sb.to(torch.int32)
    dec = torch.zeros((Tp, W, B), dtype=torch.int32, device=dev)
    for t in range(0, t_real, 2):
        cand, d = _butterfly(m[:S2], m[S2:], pens(e, t))  # [2(b1), S2, B]
        dec[t] = words(d.permute(1, 0, 2).reshape(S, B))   # state 2*s2 + b1
        if t + 1 == t_real:
            m = cand.permute(1, 0, 2).reshape(S, B)
            break
        fin, dfin = [], []
        for b1 in (0, 1):
            c2, d2 = _butterfly(cand[b1, :S4], cand[b1, S4:], pens(e2[b1], t + 1))
            fin.append(c2)   # [2(b2), S4, B]
            dfin.append(d2)
        # state 4*s2 + 2*b1 + b2 from [b1, b2, s2, B]
        m = torch.stack(fin).permute(2, 0, 1, 3).reshape(S, B)
        dec[t + 1] = words(torch.stack(dfin).permute(2, 0, 1, 3).reshape(S, B))
    return metrics_like(metrics_sb).copy_(m), _into(out, dec)


def acs_update_tb2(code: CodeSpec, numeric: NumericSpec, metrics_sb: torch.Tensor,
                   symbols_trb: torch.Tensor, t_real: int, out: torch.Tensor | None = None):
    """Whole-frame ACS in state order, two steps a pass: the contract of
    ``kernels.acs_update_tb``.

    Args:
      metrics_sb: ``[S, B]`` int32 of any strides.
      symbols_trb: ``[Tp, R, B]`` int32 of any strides, ``Tp >= t_real``.
      t_real: true number of trellis steps (odd or even); later steps are
        never run.
      out: where the words go (a contiguous ``[Tp, W, B]`` int32 view), or
        None for a new tensor.

    Returns ``(metrics [S, B] int32 in the layout of
    kernels.metrics_like(metrics_sb), dec_words [Tp, W, B] int32)``.
    """
    if not metrics_sb.is_cuda:
        return acs_update_tb2_ref(code, numeric, metrics_sb, symbols_trb, t_real, out)
    _check_code(code)
    return launch_acs_tb("acs_update_tb2", 2, code, numeric, metrics_sb, symbols_trb, t_real,
                         out)
