"""The decoder's update on the kernels' own layout.

``ViterbiDecoder(backend="cuda")`` hands the whole-frame ACS kernels the
caller's batch-major symbols and metrics as views, keeps its words in one
``[Tcap, W, B]`` buffer that the updates write through ``out=`` rows, and
walks that buffer where it lies.  On the CPU (the kernels' plain versions)
this file holds, on every whole-frame route -- the in-place pair (forced),
the state-order pair and its depth-2 form -- the decoder's bytes, metrics,
offset, path metric and words bit-equal to the JAX package's ``pallas``
decoder (interpret mode) at the shapes of ``test_torch_decoder.py`` (B=4 and
B=3, 16-byte frames): one-shot, blockwise with edges off the rotation phases
and a buffer that grows three times, and resumed from JAX state through
``convert``.  The three wrappers take views and return what they return on
contiguous tensors; the launchers' stride arguments are replayed on the CPU
by reading and writing host memory through them, as the kernels address
device memory; the symbol fetches of the source are replayed in their index
arithmetic.  Tests marked ``cuda`` hold the kernels on batch-major views to
their contiguous launches and plain versions; they skip without a card.
Tolerance: exact equality (integer arithmetic)."""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.convert import (code_from_fields, decoder_state_from_numpy,
                                                       numeric_from_fields)
from ka9q_viterbi_comparison_tpu_torch.ops import acs as pacs
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, dispatch, inplace as pip, \
    kernels as pk, kernels2 as pk2

# The decoder's routes: (KA9Q_*_INPLACE, the port's update of K <= 9).
ROUTES = {"inplace": ("1", None), "state_order": ("0", "acs_update_tb"),
          "depth2": ("0", "acs_update_tb2")}


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def frames(jc, jn, B, n_bytes, noise, seed):
    """Symbols ``[B, T, R]`` int32: encoded + uniform integer noise, clipped."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data)))
    sym = np.clip(sym + rng.integers(-noise, noise + 1, size=sym.shape), jn.soft_low, jn.soft_high)
    return sym.astype(np.int32).reshape(B, -1, jc.R)


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    """Set the route in both packages; on the depth-2 route the port's
    state-order update is ``acs_update_tb2`` at every batch (its threshold is
    B=1024; it has the contract of ``acs_update_tb``, which the JAX decoder
    runs at these batches).  Returns the route and the list of the
    state-order updates the port called."""
    flag, impl = ROUTES[request.param]
    monkeypatch.setenv("KA9Q_TORCH_INPLACE", flag)
    monkeypatch.setenv("KA9Q_TPU_INPLACE", flag)
    called = []
    real = dispatch._small_k_impl

    def small_k_impl(batch):
        fn = pk2.acs_update_tb2 if impl == "acs_update_tb2" else real(batch)
        called.append(fn.__name__)
        return fn

    monkeypatch.setattr(dispatch, "_small_k_impl", small_k_impl)
    return request.param, called


def words_u32(blocks):
    return torch.cat(blocks, dim=1).numpy().view(np.uint32)


def assert_state_equal(pdec, jdec, nbits):
    np.testing.assert_array_equal(pdec.chainback(nbits).numpy(), np.asarray(jdec.chainback(nbits)))
    np.testing.assert_array_equal(pdec.metrics.numpy(), np.asarray(jdec.metrics))
    np.testing.assert_array_equal(pdec.renorm_offset.numpy(), np.asarray(jdec.renorm_offset))
    for end in (0, 5):
        np.testing.assert_array_equal(pdec.path_metric(end).numpy(),
                                      np.asarray(jdec.path_metric(end)))
    np.testing.assert_array_equal(words_u32(pdec._decision_blocks),
                                  np.concatenate([np.asarray(w) for w in jdec._decision_blocks],
                                                 axis=1))


def check_route(route, pdec):
    name, called = route
    assert all(isinstance(b, tuple) for b in pdec._blocks), "words outside the buffer"
    if name == "inplace":
        assert called == []
    else:
        assert called and set(called) == {ROUTES[name][1]}


def test_one_shot_and_blockwise_match_jax(route):
    """A whole frame in one update, then the same frame in four blocks whose
    edges (10, 25, 61) are off the rotation phases and each outgrow the
    word buffer: bytes, metrics, offset, path metric and words equal the JAX
    decoder's one-shot state (the in-place words are packed by global step,
    so the blocks' words are the whole frame's)."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    B, n = 4, 16
    sym = frames(jc, jn, B, n, 3, seed=1)
    jdec = J.ViterbiDecoder(jc, jn, batch=B, backend="pallas")
    jdec.update(jnp.asarray(sym.reshape(B, -1)))

    pdec = P.ViterbiDecoder(pc, pn, batch=B, backend="cuda", device="cpu")
    pdec.update(torch.from_numpy(sym))
    check_route(route, pdec)
    assert pdec._buf.shape[0] == sym.shape[1]  # one update: a buffer of its steps
    assert_state_equal(pdec, jdec, 8 * n)

    pdec.reset()
    bufs = []
    edges = (0, 10, 25, 61, sym.shape[1])
    for lo, hi in zip(edges, edges[1:]):
        pdec.update(torch.from_numpy(sym[:, lo:hi]))
        bufs.append(pdec._buf)
    check_route(route, pdec)
    assert len({id(b) for b in bufs}) == len(bufs)  # grown at every block after the first
    assert pdec._blocks == list(zip(edges, edges[1:]))
    assert pdec._steps == sym.shape[1]
    assert_state_equal(pdec, jdec, 8 * n)


def test_resume_from_jax_state(route):
    """A JAX decoder's state after 61 steps, carried across through
    ``convert``, lands in the port's word buffer and resumes there: the whole
    stream's bytes, metrics, offset, path metric and words equal JAX's."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    B, n, half = 3, 16, 61
    sym = frames(jc, jn, B, n, 3, seed=5)
    jdec = J.ViterbiDecoder(jc, jn, batch=B, backend="pallas")
    jdec.update(jnp.asarray(sym[:, :half]))
    pdec = P.ViterbiDecoder(pc, pn, batch=B, backend="cuda", device="cpu")
    decoder_state_from_numpy(pdec, np.asarray(jdec.metrics), np.asarray(jdec._decision_blocks[0]),
                             np.asarray(jdec.renorm_offset), jdec._steps)
    assert pdec._blocks == [(0, half)]
    pdec.update(torch.from_numpy(sym[:, half:]))
    jdec.update(jnp.asarray(sym[:, half:]))
    check_route(route, pdec)
    assert_state_equal(pdec, jdec, 8 * n)


def test_offset_is_a_view_of_zero():
    """The whole-frame routes' offset launches nothing: a stride-0 view of a
    cached zero, equal to zeros, refusing in-place writes; the decoder adds
    nothing to ``renorm_offset`` there."""
    pc, pn = P.VITERBI27, P.soft8_spec(2)
    sym = torch.zeros((3, 40, 2), dtype=torch.int32)
    m, words, off = dispatch.acs_update(pc, pn, pacs.init_metrics(pc, pn, 3), sym)
    assert off.shape == (3,) and off.stride() == (0,) and not off.any()
    assert off.data_ptr() == dispatch.zero_offset(7, "cpu").data_ptr()
    with pytest.raises(RuntimeError):
        off.add_(1)
    dec = P.ViterbiDecoder(pc, pn, batch=3, backend="cuda", device="cpu")
    offset = dec.renorm_offset
    dec.update(sym)
    assert dec.renorm_offset is offset
    with pytest.raises(ValueError, match="large-K"):
        dispatch.acs_update(P.VITERBI615, P.soft8_spec(6), pacs.init_metrics(P.VITERBI615,
                            P.soft8_spec(6), 1), torch.zeros((1, 2, 6), dtype=torch.int32),
                            out=torch.empty((2, 512, 1), dtype=torch.int32))


# -- the three wrappers on views -------------------------------------------

# (wrapper, plain version, code, t0 of the in-place form)
K10 = P.CodeSpec("k10r2", 10, 2, (0o1167, 0o1546))
WRAPPERS = [
    pytest.param("tb", P.VITERBI27, 0, id="tb-k7"),
    pytest.param("tb2", P.VITERBI29, 0, id="tb2-k9"),
    pytest.param("tb2", K10, 0, id="tb2-k10"),
    pytest.param("inplace", P.VITERBI27, 0, id="inplace-k7"),
    pytest.param("inplace", P.VITERBI27, 5, id="inplace-k7-t0"),
    pytest.param("inplace", K10, 4, id="inplace-k10-t0"),
]
FNS = {"tb": (pk.acs_update_tb, pk.launch_acs_tb), "tb2": (pk2.acs_update_tb2, pk.launch_acs_tb),
       "inplace": (pip.acs_update_inplace, pip.launch_acs_inplace)}


def view_inputs(code, B=5, T=45, Tp=64, seed=0):
    """Batch-major metrics ``[B, S]`` and symbols ``[B, Tp, R]`` (time
    padded past ``T``; soft8 values and a random metric spread)."""
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.integers(0, 900, size=(B, code.num_states)).astype(np.int32))
    s = torch.from_numpy(rng.integers(-127, 128, size=(B, Tp, code.R)).astype(np.int32))
    return m, s, T


def call(which, code, numeric, m_sb, s_trb, T, t0, fn=None):
    fn = fn or FNS[which][0]
    return fn(code, numeric, m_sb, s_trb, T, t0) if which == "inplace" else \
        fn(code, numeric, m_sb, s_trb, T)


@pytest.mark.parametrize("which,code,t0", WRAPPERS)
def test_wrappers_take_views(which, code, t0):
    """Batch-major views in, the same metrics and words out as from
    contiguous ``[Tp, R, B]`` and ``[S, B]``; the exit metrics come in the
    entry metrics' layout (``m.T`` of a new ``[B, S]``)."""
    numeric = P.soft8_spec(code.R)
    m, s, T = view_inputs(code)
    got_m, got_d = call(which, code, numeric, m.T, s.permute(1, 2, 0), T, t0)
    want_m, want_d = call(which, code, numeric, m.T.contiguous(), s.permute(1, 2, 0).contiguous(),
                          T, t0)
    assert torch.equal(got_m, want_m) and torch.equal(got_d, want_d)
    assert got_m.stride() == (1, code.num_states) and got_m.T.is_contiguous()
    assert want_m.is_contiguous()


# -- the launchers' stride arguments, replayed on host memory ---------------

def _words(ptr: int, n: int) -> np.ndarray:
    """``n`` int32 words of host memory at address ``ptr`` (writable)."""
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(ptr))


def _index(shape, strides) -> np.ndarray:
    idx = np.zeros(shape, dtype=np.int64)
    for d, (n, st) in enumerate(zip(shape, strides)):
        idx = idx + (np.arange(n) * st).reshape([-1 if e == d else 1 for e in range(len(shape))])
    return idx


def gather(ptr, shape, strides) -> torch.Tensor:
    """What a kernel reads: element ``i`` at ``ptr + 4 * sum(i_d * stride_d)``."""
    idx = _index(shape, strides)
    return torch.from_numpy(_words(ptr, int(idx.max()) + 1)[idx].copy())


def scatter(ptr, strides, values: torch.Tensor) -> None:
    idx = _index(tuple(values.shape), strides)
    _words(ptr, int(idx.max()) + 1)[idx] = values.numpy()


def replay_launch(counter, fn_name, device, *args):
    """A whole-frame ACS launcher run on host memory: its arguments decoded in
    the order of ``_build._SIGNATURES`` (``kernels.acs_launch_args``), the
    inputs read through their pointers and strides, the plain version run on
    them, metrics written through the exit strides and words into the
    contiguous ``[Tp, W, B]`` rows, as the kernel addresses them."""
    assert len(args) + 1 == len(_build._SIGNATURES[fn_name])  # the stream comes last
    m_in, ms, mb, sym, st, sr, sb = args[:7]
    inplace_form = fn_name == "viterbi_acs_inplace"
    ntab = 3 if inplace_form else 2
    m_out, os_, ob, dec = args[7 + ntab:11 + ntab]
    K, R, comp, low, hl, B, t_real, *p0 = args[11 + ntab:]
    code = REPLAY_CODES[(K, R)]
    assert comp == int(pk.complement_form(code))
    numeric = dataclasses.replace(P.soft8_spec(R), soft_low=low, soft_high=hl - low)
    m = gather(m_in, (code.num_states, B), (ms, mb))
    s = gather(sym, (t_real, R, B), (st, sr, sb))
    if inplace_form:
        m2, d = pip.acs_update_inplace_ref(code, numeric, m, s, t_real, p0[0])
    elif fn_name == "viterbi_acs_tb2":
        m2, d = pk2.acs_update_tb2_ref(code, numeric, m, s, t_real)
    else:
        m2, d = pk.acs_update_tb_ref(code, numeric, m, s, t_real)
    scatter(m_out, (os_, ob), m2)
    W = code.decision_words
    scatter(dec, (W * B, B, 1), d)
    REPLAYED.append({"fn": fn_name, "counter": counter, "metrics": (ms, mb), "symbols": (st, sr, sb),
                     "exit": (os_, ob)})


REPLAY_CODES = {(c.K, c.R): c for c in (P.VITERBI27, P.VITERBI29, K10)}
REPLAYED: list = []


@pytest.fixture
def pinned(monkeypatch):
    """The card route on CPU tensors: the checks without the device test,
    ``_build.launch`` replayed on host memory."""
    def check(name, t, shape, contiguous=True):
        assert t.dtype == torch.int32 and tuple(t.shape) == tuple(shape), name
        assert t.is_contiguous() or not contiguous, name

    monkeypatch.setattr(_build, "check_cuda_int32", check)
    monkeypatch.setattr(_build, "launch", replay_launch)
    REPLAYED.clear()
    return REPLAYED


@pytest.mark.parametrize("which,code,t0", WRAPPERS)
def test_launch_arguments_replayed(pinned, which, code, t0):
    """Each launcher gets every tensor's own ``stride()``: batch-major views,
    symbols that are a slice of a wider batch, and contiguous inputs, each
    replayed through its arguments, give the plain version's metrics and
    words on contiguous inputs."""
    numeric = P.soft8_spec(code.R)
    m, s, T = view_inputs(code, B=6)
    # The same frames at the even rows of batches of 12.
    m_wide = torch.stack([m, m + 1], dim=1).reshape(12, -1)
    s_wide = torch.stack([s, s.flip(0)], dim=1).reshape(12, *s.shape[1:])
    want_m, want_d = call(which, code, numeric, m.T.contiguous(),
                          s.permute(1, 2, 0).contiguous(), T, t0)
    cases = [(m.T, s.permute(1, 2, 0)), (m_wide[::2].T, s_wide[::2].permute(1, 2, 0)),
             (m.T.contiguous(), s.permute(1, 2, 0).contiguous())]
    for m_sb, s_trb in cases:
        got_m, got_d = call(which, code, numeric, m_sb, s_trb, T, t0, FNS[which][1]) \
            if which == "inplace" else FNS[which][1](
                f"acs_update_{which}", 1 if which == "tb" else 2, code, numeric, m_sb, s_trb, T)
        assert torch.equal(got_m, want_m)
        assert torch.equal(got_d[:T], want_d[:T])
        rec = pinned[-1]
        assert rec["metrics"] == m_sb.stride() and rec["symbols"] == s_trb.stride()
        assert rec["exit"] == got_m.stride() == pk.metrics_like(m_sb).stride()
    assert len(pinned) == len(cases)


# -- the symbol fetches of csrc/viterbi_small.cu, replayed ------------------

def warp_fetch(sym_frame_flat, ts, rs, R, s, STG, vlo, t_real):
    """``WarpStages::fetch(s)`` of one frame: lane l stages step l of the
    stage into ``ysm[r][l]``, from ``sym_frame_flat`` (the memory from the
    frame's first symbol) by strides ``ts``, ``rs``; returns the staged
    words and the element offsets each load (r) of the warp reads."""
    y = np.zeros((R, 32), dtype=np.int64)
    offsets = np.zeros((R, 32), dtype=np.int64)
    for lane in range(32):
        t = min(max(s * STG + lane - vlo, 0), t_real - 1)
        for r in range(R):
            offsets[r, lane] = t * ts + r * rs
            y[r, lane] = sym_frame_flat[offsets[r, lane]]
    return y, offsets


def block_fetch(sym_frame_flat, ts, rs, R, s, t_real):
    """The in-place block kernel's ``fetch(s)`` (and ``stage_symbols``):
    thread i stages (step, symbol) = (i / R, i % R) into ``ysm[i]``;
    returns the staged words and the element offsets thread i reads."""
    i = np.arange(32 * R)
    t = np.minimum(32 * s + i // R, t_real - 1)
    offsets = t * ts + (i % R) * rs
    return sym_frame_flat[offsets], offsets


@pytest.mark.parametrize("R", [1, 2, 3, 6, 8])
def test_fetches_stage_the_same_symbols_in_both_layouts(R):
    """The warp fetch and the block fetch stage the same symbols from
    batch-major and time-major tensors of the same frames, with the
    clamping at the frame's ends.  In batch-major memory an interior
    stage's loads read one contiguous run of 32 R words between them (the
    warp's R loads, the block's threads in order); in time-major memory the
    steps lie R*B words apart."""
    B, T = 3, 75
    rng = np.random.default_rng(R)
    s_btr = torch.from_numpy(rng.integers(-127, 128, size=(B, T, R)).astype(np.int32))
    layouts = {"batch-major": (s_btr.permute(1, 2, 0), s_btr),
               "time-major": (s_btr.permute(1, 2, 0).contiguous(),) * 2}
    for STG, vlo in ((32, 0), (30, 4)):  # the state-order and the in-place K=7 stages
        for b in range(B):
            staged = {}
            for name, (v, base) in layouts.items():
                st, sr, sb = v.stride()
                flat = base.reshape(-1).numpy()[b * sb:]
                staged[name] = [(warp_fetch(flat, st, sr, R, s, STG, vlo, T),
                                 block_fetch(flat, st, sr, R, s, T)) for s in range(4)]
            for s, (bm, tm) in enumerate(zip(staged["batch-major"], staged["time-major"])):
                (wy_b, wo_b), (by_b, bo_b) = bm
                (wy_t, _), (by_t, bo_t) = tm
                np.testing.assert_array_equal(wy_b, wy_t)
                np.testing.assert_array_equal(by_b, by_t)
                u = np.clip(s * STG + np.arange(32) - vlo, 0, T - 1)
                np.testing.assert_array_equal(wy_b, s_btr[b].numpy()[u].T)
                if vlo <= s * STG and s * STG + 31 - vlo < T:  # an interior stage
                    first = (s * STG - vlo) * R
                    np.testing.assert_array_equal(np.sort(wo_b.reshape(-1)),
                                                  first + np.arange(32 * R))
                if 32 * s + 31 < T:
                    np.testing.assert_array_equal(bo_b, 32 * s * R + np.arange(32 * R))
                    assert (np.diff(bo_t) != 1).all() or B == 1


# -- on the card: rows 1, 3 and 5 on batch-major views ----------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


K13 = P.CodeSpec("k13r2", 13, 2, (0o10533, 0o17661))
# (wrapper, code, t0): K=7, K=9 and K=15 (the depth-2 block form ends at K=13).
CARD = [pytest.param(w, c, t0, id=f"{w}-{c.name}")
        for w, c, t0 in (("tb", P.VITERBI27, 0), ("tb", P.VITERBI29, 0), ("tb", P.VITERBI615, 0),
                         ("tb2", P.VITERBI27, 0), ("tb2", P.VITERBI29, 0), ("tb2", K13, 0),
                         ("inplace", P.VITERBI27, 3), ("inplace", P.VITERBI29, 0),
                         ("inplace", P.VITERBI615, 5))]


@pytest.mark.cuda
@pytest.mark.parametrize("which,code,t0", CARD)
def test_cuda_views_equal_contiguous_launch(cuda_device, which, code, t0):
    """A batch-major view launches the kernel once and gives the words and
    metrics of the contiguous launch and of the plain version, bit for bit
    (a ragged batch and time padded past ``t_real``)."""
    numeric = P.soft8_spec(code.R)
    m, s, T = view_inputs(code, B=33, T=301, Tp=320)
    m, s = m.cuda(), s.cuda()
    name = {"tb": "acs_update_tb", "tb2": "acs_update_tb2", "inplace": "acs_update_inplace"}[which]
    before = _build.LAUNCHES[name]
    got_m, got_d = call(which, code, numeric, m.T, s.permute(1, 2, 0), T, t0)
    assert _build.LAUNCHES[name] == before + 1
    want_m, want_d = call(which, code, numeric, m.T.contiguous(),
                          s.permute(1, 2, 0).contiguous(), T, t0)
    ref = {"tb": pk.acs_update_tb_ref, "tb2": pk2.acs_update_tb2_ref,
           "inplace": pip.acs_update_inplace_ref}[which]
    ref_m, ref_d = call(which, code, numeric, m.T.cpu(), s.permute(1, 2, 0).cpu(), T, t0, ref)
    torch.cuda.synchronize()
    assert got_m.stride() == (1, code.num_states)
    assert torch.equal(got_m, want_m) and torch.equal(got_d[:T], want_d[:T])
    assert torch.equal(got_m.cpu(), ref_m) and torch.equal(got_d[:T].cpu(), ref_d[:T])


@pytest.mark.cuda
def test_cuda_decoder_update_reads_views(cuda_device):
    """The decoder's whole-frame update on both routes: one kernel launch
    and the plain decoder's bytes, metrics and words."""
    pc, pn = P.VITERBI27, P.soft8_spec(2)
    for B in (130, 33):
        m, s, T = view_inputs(pc, B=B, T=200, Tp=200)
        got = P.ViterbiDecoder(pc, pn, B, "cuda")
        want = P.ViterbiDecoder(pc, pn, B, "cuda", device="cpu")
        _build.reset_launch_counts()
        got.update(s.cuda())
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        assert launched == {"acs_update_inplace" if B >= 128 else "acs_update_tb": 1}
        want.update(s)
        assert torch.equal(got.metrics.cpu(), want.metrics)
        assert torch.equal(got._decision_blocks[0].cpu(), want._decision_blocks[0])
        assert torch.equal(got.chainback(8 * 24).cpu(), want.chainback(8 * 24))
