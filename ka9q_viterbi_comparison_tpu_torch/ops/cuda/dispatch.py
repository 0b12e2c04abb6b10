"""Backend dispatch for the CUDA kernels.

Port of ``ka9q_viterbi_comparison_tpu/ops/pallas/dispatch.py`` (``acs_update``,
``_large_update``, ``_small_k_impl``, ``chainback``, ``use_inplace``,
``supports_chainback``, ``unpack_bit_words``, ``phase_fns`` and
``_inplace_phase_fns`` with their chains).  It bridges the batch-major public
API (``[B, ...]`` tensors, the layout of the portable path) to the kernels'
layouts.  The JAX dispatch pads the batch to 128 lanes and transposes
symbols and metrics, because on a TPU the frames are the lanes; on the card
a warp or a block owns a frame, and the whole-frame kernels read the
caller's batch-major symbols and metrics by their strides, so
``acs_update`` hands them views: no pad and no copy.

Routes, decided on the code and the batch B alone so that update and
chainback agree:

* 5 < K <= 15 and B >= 128 (or ``KA9Q_TORCH_INPLACE=1``): the in-place
  rotating-address pair (``inplace.py``), when one block's shared memory fits
  the card.  The predicate is the JAX package's, so at the same batch both
  packages pack the same words -- except at K=15 and B > 256, where the JAX
  package leaves the in-place kernel for a TPU compiler fault
  (``ops/pallas/dispatch.py:89``) and this port does not.
* K <= 9 otherwise: the state-order pair (``kernels.py``); from B = 1024 up
  its update is the depth-2 kernel (``kernels2.py``), which has the same
  contract, so no output depends on the threshold.
* K > 9 otherwise: the state-blocked large-K kernels.  R <= 2 codes with a
  state block of at least 512 states (every such K >= 10, ICE among them)
  take the depth-4 kernel ``acs_update_large4`` (``large_k4.py``, its 1-3
  step remainder on ``large_k2.py``), the others the pair kernel
  ``acs_update_large2`` (``large_k2.py``, its odd tail on ``large_k.py``).
  The choice follows from the code alone, as the JAX package's default does.
  Their words are in canonical order and walk through ``chainback_tb``,
  where they lie, up to K=24 (the JAX package walks them in ``jnp`` above
  K=15).

``phase_fns`` gives the update and traceback of every family as separate
phases in the kernels' own layout, with no transpose, pad or copy inside a
phase, and chains of ``k`` phases queued on one stream with no host
synchronisation between links (a traceback's end state travels as a device
tensor).  In the large-K family above K=15 the update returns a walk table
in place of words (``f8`` for whole frames, else ``f4``, written by the
depth-4 kernel; else words and tables built from them) and the traceback
retires 8 or 4 steps a fetch (``walk.chainback_planes``, the kernel of
``ops/radix_planes.py``'s table walk).

The batch is not padded: each CUDA block owns whole frames, so there is no
lane width to fill (the JAX package pads to 128 lanes only on a TPU).  Time
is padded to whole traceback words (32 steps) before the traceback, which is
the shape the Pallas traceback kernels take too.  A traceback to bytes or
bits (``chainback``, ``walk_bytes``) is one launch of the kernel's
``bytes`` or ``bits`` form: the kernel writes them itself.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ...configs import CodeSpec, NumericSpec
from ...utils.bits import unpack_words_to_bits
from .. import acs, radix_planes as rp
from . import flags, inplace, kernels, kernels2, large_k2, large_k4, walk

__all__ = ["acs_update", "chainback", "phase_fns", "make_chains", "use_inplace", "supports",
           "whole_frame", "zero_offset", "supports_chainback", "shared_cap", "fits_shared",
           "unpack_bit_words", "walk_bytes"]


@functools.lru_cache(maxsize=None)
def shared_cap(device: torch.device) -> int | None:
    """The shared memory a block of the card of ``device`` may opt in to
    (``torch.cuda.get_device_properties``, read once a device: every
    update and traceback routes by it); None off a card."""
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", props.shared_memory_per_block)


def fits_shared(code: CodeSpec, device: torch.device) -> bool:
    """Whether one in-place ACS block's shared memory
    (``inplace.inplace_smem_bytes``: what the launcher in the source asks for)
    fits the card of ``device`` (``shared_cap``; the block also needs at most
    1024 threads, which the launcher never exceeds).  The plain versions that
    serve CPU tensors have no such limit."""
    cap = shared_cap(device)
    return cap is None or inplace.inplace_smem_bytes(code) <= cap


def supports(code: CodeSpec) -> bool:
    """The state-order pair serves small trellises (K <= 9)."""
    return code.K <= 9


def supports_chainback(code: CodeSpec) -> bool:
    """``chainback_tb`` walks canonical words up to K=24 (2^18 words a
    step)."""
    return code.K <= kernels.TB_MAX_K


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


def whole_frame(code: CodeSpec, batch: int, device: torch.device | str = "cpu") -> bool:
    """Whether ``acs_update`` takes a whole-frame kernel at this batch (the
    in-place pair, or the state-order pair for K <= 9): its words can go
    into ``out=`` rows and its offset is zero.  Else the large-K route."""
    return use_inplace(code, batch, device) or supports(code)


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def zero_offset(batch: int, device: torch.device | str) -> torch.Tensor:
    """The renormalisation offset of the whole-frame routes: ``[batch]``
    int32 zeros as a stride-0 view of one cached device zero, so that a call
    launches nothing for it.  Equal to the JAX package's zero offset; an
    in-place write to it raises (its elements share one location)."""
    return _zero(torch.device(device)).expand(batch)


def unpack_bit_words(bits_words: torch.Tensor, T: int) -> torch.Tensor:
    """``[Tp//32, B]`` int32 -> trellis bits ``[B, T]`` uint8."""
    return unpack_words_to_bits(bits_words.T)[:, :T]


@functools.lru_cache(maxsize=None)
def _rot_index(code: CodeSpec, t: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """``inplace.rot_perm`` on ``device``, uploaded once per phase: a block's
    update then copies nothing from the host."""
    return torch.as_tensor(inplace.rot_perm(code, t, inverse), device=device)


def _inplace_update(code, numeric, metrics, symbols, t0, out):
    """Batch-major wrapper over the in-place kernel, which reads the
    symbols ``[B, T, R]`` and metrics ``[B, S]`` where they lie and writes
    the exit metrics through the transpose of a new ``[B, S]``.  Metrics
    cross the call in state order: a gather where a block edge is not at
    rotation phase 0, at ``t0`` before the kernel and at ``t0 + T`` after."""
    B, T, R = symbols.shape
    nrot = code.K - 1
    t0 = int(t0) % nrot
    dev = metrics.device
    m = metrics.to(torch.int32)
    if t0:
        m = m[:, _rot_index(code, t0, False, dev)]
    m, dec = inplace.acs_update_inplace(code, numeric, m.T, symbols.to(torch.int32).permute(1, 2, 0),
                                        T, t0, out)
    m = m.T  # [B, S]: the exit metrics come in the entry metrics' layout
    if (t0 + T) % nrot:
        m = m[:, _rot_index(code, (t0 + T) % nrot, True, dev)]
    return m, dec.permute(2, 0, 1), zero_offset(B, dev)  # words [B, T, W], position-packed


def _large_update(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
                  symbols: torch.Tensor, time_major: bool = False):
    """State-blocked large-K update at the depth the code admits: four steps
    a launch (``large_k4``) for R <= 2 trellises of at least 512 states, else
    the pair kernel (``large_k2``)."""
    fn = large_k4.acs_update_large4 if large_k4.supports(code) else large_k2.acs_update_large2
    return fn(code, numeric, metrics.to(torch.int32).contiguous(),
              symbols.to(torch.int32).contiguous(), time_major=time_major)


def _small_k_impl(batch: int):
    """The state-order update for K <= 9: the depth-2 kernel from batch 1024
    up (the JAX package's threshold, which reads the batch padded to TPU
    lanes; here a block owns one frame, so the batch itself), the single-step
    kernel below.  Both have one contract."""
    if batch >= 1024:
        return kernels2.acs_update_tb2
    return kernels.acs_update_tb


_end_states = kernels._end_states  # the plain walks' end state, [1, B] int32


def acs_update(code: CodeSpec, numeric: NumericSpec, metrics: torch.Tensor,
               symbols: torch.Tensor, t0: int = 0, out: torch.Tensor | None = None):
    """Batch-major wrapper matching ``ops.acs.acs_update``'s contract:
    ``(metrics [B,S], symbols [B,T,R]) -> (metrics, words [B,T,W], offset)``.

    ``t0``: trellis steps already consumed (blockwise resume); only the
    in-place pair reads it.  ``out``: on the whole-frame routes
    (``whole_frame``), a contiguous ``[T, W, B]`` int32 view where the
    kernel writes the words (rows of a decoder's word buffer); the words
    returned are then ``out.permute(2, 0, 1)``.

    The whole-frame routes hand the kernels ``symbols.permute(1, 2, 0)`` and
    ``metrics.T`` as views (any strides) and get the exit metrics as the
    transpose of a new ``[B, S]``: one launch on the state-order route; on
    the in-place route the launch and, where ``t0 + T`` is not a multiple of
    K-1, the gather that takes the exit metrics back to state order (and
    one before it where ``t0`` is not).  Their offset is ``zero_offset``, a
    view of a cached zero that costs no launch (int32 has the headroom), as
    the JAX package's is zero there; the large-K route returns its shifts.
    """
    B, T, R = symbols.shape
    if use_inplace(code, B, metrics.device):
        return _inplace_update(code, numeric, metrics, symbols, t0, out)
    if not supports(code):
        if out is not None:
            raise ValueError(f"acs_update: {code.name} at B={B} takes the large-K route, whose "
                             "words do not go into out= rows")
        return _large_update(code, numeric, metrics, symbols)
    m, dec = _small_k_impl(B)(code, numeric, metrics.to(torch.int32).T,
                              symbols.to(torch.int32).permute(1, 2, 0), T, out)
    return m.T, dec.permute(2, 0, 1), zero_offset(B, metrics.device)


def chainback(code: CodeSpec, words: torch.Tensor, num_data_bits: int,
              endstate: torch.Tensor | int = 0) -> torch.Tensor:
    """Batch-major wrapper matching ``ops.chainback.chainback``'s contract;
    ``endstate`` is an int or a device tensor (0-d, ``[B]`` or ``[1, B]``).

    Routing mirrors ``acs_update``: words of the in-place pair are packed in
    position order and walk through ``chainback_inplace``, the others through
    ``chainback_tb`` (any K up to 24, where the JAX package walks above K=15
    in jnp).  The kernels walk the batch-major words where they lie (at ICE a
    frame holds 2^18 words a step) and write the bytes themselves: one
    launch."""
    if num_data_bits % 8 != 0:
        raise ValueError("num_data_bits must be a multiple of 8")
    B, T, _ = words.shape
    inplace_route = use_inplace(code, B, words.device)
    walk_fn = inplace.chainback_inplace if inplace_route else kernels.chainback_tb
    return walk_bytes(code, walk_fn, words.to(torch.int32).permute(1, 2, 0), T, num_data_bits,
                      endstate, *((0,) if inplace_route else ()))


def walk_bytes(code: CodeSpec, walk, dec: torch.Tensor, T: int, num_data_bits: int,
               endstate, *extra) -> torch.Tensor:
    """Decoded bytes ``[B, num_data_bits // 8]`` of a whole frame's walk (the
    first K-1 outputs, the initial state's bits, dropped): one launch of the
    bytes form of the traceback kernel ``walk`` (``kernels.chainback_tb``, or
    ``inplace.chainback_inplace`` with its ``t0`` in ``extra``) over ``dec
    [Tp, W, B]`` (any strides) from ``endstate`` (an int or a device
    tensor)."""
    lo = code.K - 1
    return walk(code, dec, endstate, T, *extra, "bytes", lo, lo + num_data_bits)


def make_chains(update_fn, chainback_impl):
    """The two chain factories of a family, from its ``update_fn(metrics,
    prepared) -> (metrics, words, offset)`` and its ``chainback_impl(words,
    endstate) -> bytes``.  ``make_update_chain(k)`` runs ``k`` updates, each
    on the metrics of the one before, and returns the last ``(metrics,
    words)``; ``make_chainback_chain(k)`` runs ``k`` tracebacks, each from
    the end state ``out[0, -1]`` of the one before (a 0-d device tensor), and
    returns the last bytes.  The links are queued on the current stream;
    nothing between them reads a tensor back to the host."""
    def make_chainback_chain(k):
        def run(words):
            out = chainback_impl(words, 0)
            for _ in range(k - 1):
                out = chainback_impl(words, out[0, -1])
            return out

        return run

    def make_update_chain(k):
        def run(metrics, prepared):
            for _ in range(k):
                metrics, words, _ = update_fn(metrics, prepared)
            return metrics, words

        return run

    return make_chainback_chain, make_update_chain


def _native_phase_fns(code: CodeSpec, numeric: NumericSpec, num_data_bits: int,
                      device: torch.device, inplace_route: bool):
    """The phases of the two whole-frame families in the kernels' own layout:
    metrics stay ``[S, B]`` and decisions ``[Tp, W, B]`` between phases
    (position-packed on the in-place route, whole frames from step 0, so
    reset metrics in state order are already in position space)."""
    from ...models.decoder import as_symbols

    walk_fn = inplace.chainback_inplace if inplace_route else kernels.chainback_tb
    walk_extra = (0,) if inplace_route else ()  # the in-place walk's t0

    def init_fn(batch):
        return acs.init_metrics(code, numeric, batch, device=device).T.contiguous()  # [S, B]

    def prepare_fn(symbols):
        sym = as_symbols(symbols, device)
        B, T, _ = sym.shape
        Tp = inplace.pad_time_inplace(code, T)  # whole traceback words
        native = F.pad(sym.permute(1, 2, 0), (0, 0, 0, 0, 0, Tp - T)).contiguous()
        return native, T, B  # [Tp, R, B]

    def update_fn(metrics_sb, prepared):
        sym_native, T, B = prepared
        if inplace_route:
            m, dec = inplace.acs_update_inplace(code, numeric, metrics_sb, sym_native, T, 0)
        else:
            m, dec = _small_k_impl(B)(code, numeric, metrics_sb, sym_native, T)
        return m, (dec, T, B), torch.zeros((B,), dtype=torch.int32, device=m.device)

    def _cb_impl(words_native, endstate):
        dec, T, _ = words_native
        return walk_bytes(code, walk_fn, dec, T, num_data_bits, endstate, *walk_extra)

    def chainback_fn(words_native):
        return _cb_impl(words_native, 0)

    return (init_fn, update_fn, chainback_fn, prepare_fn, *make_chains(update_fn, _cb_impl))


def phase_fns(code: CodeSpec, numeric: NumericSpec, num_data_bits: int,
              batch: int | None = None, device: torch.device | str = "cuda"):
    """The decoder's lifecycle as separate phases in the kernels' own layout,
    with no layout change between update and traceback: the configuration a
    benchmark times.

    Returns ``(init_fn, update_fn, chainback_fn, prepare_fn,
    make_chainback_chain, make_update_chain)``: ``init_fn(batch)`` gives
    reset metrics; ``prepare_fn(symbols [B, T, R])`` stages the symbols on
    ``device`` outside the timed phases; ``update_fn(metrics, prepared)``
    returns ``(metrics, words, offset)``; ``chainback_fn(words)`` returns the
    bytes ``[B, num_data_bits // 8]``.  The last two are the chain factories of
    ``make_chains``: ``k`` updates whose metrics feed forward, ``k``
    tracebacks each from the end state of the one before, with no host
    synchronisation between the links.

    Three families, chosen from the code and ``batch`` as ``acs_update``
    chooses.  In-place (5 < K <= 15 at ``batch >= 128``) and K <= 9: metrics
    ``[S, B]``, ``prepared = (symbols [Tp, R, B], T, B)`` with time padded to
    whole traceback words, ``words = (dec [Tp, W, B], T, B)``.  Large-K:
    metrics ``[B, S]``, symbols ``[B, T, R]``, and what ``words`` is follows
    the JAX package's defaults.  Up to K=15: the batch-major words of
    ``_large_update``, walked by ``chainback``.  Above:
    ``{"f8": table}`` from ``acs_update_large4_fields8`` for a whole frame
    (``T == num_data_bits + K - 1``), anchored at the largest step ``<= K-1``
    that leaves whole 8-step windows; else ``{"f4": table}`` from
    ``acs_update_large4_fields`` when ``T - (K-1)`` is a multiple of 4; else
    time-major words and the tables ``radix_planes.build_plane_tables`` makes
    of them.  The fields forms need the depth-4 kernel (R <= 2).

    ``batch``: the batch the caller will run (the family depends on it);
    defaults to the in-place route's threshold."""
    from ...models.decoder import as_symbols, resolve_device

    device = resolve_device(device)
    inplace_route = use_inplace(code, batch if batch else 128, device)
    if inplace_route or supports(code):
        return _native_phase_fns(code, numeric, num_data_bits, device, inplace_route)
    # Above K=15 the traceback phase walks plane tables, as the JAX package's does.
    use_planes = code.K > 15 and code.K - 1 >= rp.MIN_N
    # Anchor at the first kept data bit: the walk skips the discarded
    # initial-state steps.
    anchor = code.K - 1 if use_planes else 0
    lk4_ok = large_k4.supports(code)
    lead = anchor % 4

    def _use_fields(T: int) -> bool:
        return use_planes and lk4_ok and T > anchor and (T - anchor) % 4 == 0

    def _anchor8(T: int) -> int:
        # largest walk anchor <= K-1 with (T - anchor) % 8 == 0
        a = code.K - 1
        return a - ((a - T % 8) % 8)

    def _use_fields8(T: int) -> bool:
        # The traceback derives the anchor again, from num_data_bits, so the
        # route holds only for whole frames, where the two agree.
        return (use_planes and lk4_ok and 0 <= _anchor8(T) < T
                and T == num_data_bits + code.K - 1)

    def init_fn(batch):
        return acs.init_metrics(code, numeric, batch, device=device)

    def prepare_fn(symbols):
        return as_symbols(symbols, device).contiguous()

    def update_fn(metrics, symbols):
        T = symbols.shape[1]
        if _use_fields8(T):
            a8 = _anchor8(T)
            m, f8, off = large_k4.acs_update_large4_fields8(code, numeric, metrics, symbols,
                                                            a8 % 8)
            return m, {"f8": f8[(a8 - a8 % 8) // 8:]}, off
        if _use_fields(T):
            m, f4, off = large_k4.acs_update_large4_fields(code, numeric, metrics, symbols, lead)
            return m, {"f4": f4[(anchor - lead) // 4:]}, off
        if use_planes:
            m, w_tm, off = _large_update(code, numeric, metrics, symbols, time_major=True)
            return m, (w_tm, rp.build_plane_tables(code, w_tm, anchor)), off
        return _large_update(code, numeric, metrics, symbols)

    def _cb_impl(words, endstate):
        if not use_planes:
            return chainback(code, words, num_data_bits, endstate)
        if isinstance(words, dict):  # tables written by the kernel
            cb_anchor = _anchor8(num_data_bits + code.K - 1) if "f8" in words else anchor
            return walk.chainback_planes(code, None, words, num_data_bits, endstate, cb_anchor)
        w_tm, tabs = words
        return walk.chainback_planes(code, w_tm, tabs, num_data_bits, endstate, anchor)

    def chainback_fn(words):
        return _cb_impl(words, 0)

    # An update link is the whole update phase: the kernel and, on the route
    # that builds its tables from words, the table build.
    return (init_fn, update_fn, chainback_fn, prepare_fn, *make_chains(update_fn, _cb_impl))
