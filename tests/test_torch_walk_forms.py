"""The tracebacks' output forms against the JAX package.

``chainback_tb`` and ``chainback_inplace`` write their walk's outputs as
packed words, as a step a byte for steps ``[lo, hi)`` (``bits``) or as data
bytes MSB-first (``bytes``); their end state comes from an int, a tensor or
the argmin of the frame's metrics; a frame may start its walk from state 0
at a step of its own.  On the CPU each form's plain version is held against
the JAX package: the Pallas tracebacks in interpret mode at the shapes of
``tests/test_torch_kernels.py`` followed by the JAX ``unpack_bit_words`` and
``bits_to_bytes``; at K=15 the JAX ``jnp`` walk (``ops/chainback.py``) on
random words; the argmin against ``jnp.argmin`` on metrics with planted
ties; a start step against the JAX walk of the words zeroed from that step
on.  Tests marked ``cuda`` hold each form of the kernels against its plain
version and skip where there is no card.  Tolerance: none (bit-identical).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs, chainback as jcb
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import dispatch as jdispatch, inplace as jip, kernels as jk
from ka9q_viterbi_comparison_tpu.utils import bits as jbits
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, inplace as pip, kernels as pk

B = 4


def ported(jc):
    return code_from_fields(jc.name, jc.K, jc.R, jc.polys)


def _inputs(jc, jn, seed):
    """``tests/test_torch_kernels.py``'s noisy 8-byte frames: symbols ``[T,
    R, B]`` and entry metrics ``[S, B]``."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, 8), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    sym = np.clip(sym + rng.integers(-4, 5, size=sym.shape), jn.soft_low, jn.soft_high)
    m0 = np.asarray(jacs.init_metrics(jc, jn, B)).T + rng.integers(0, 40, size=(jc.num_states, B))
    return (np.ascontiguousarray(sym.transpose(1, 2, 0), dtype=np.int32),
            np.ascontiguousarray(m0, dtype=np.int32))


def _padded(s, Tp):
    out = np.zeros((Tp,) + s.shape[1:], np.int32)
    out[:s.shape[0]] = s
    return out


def _as_torch(words):
    return torch.from_numpy(np.array(words).view(np.int32))


def _cuts(K, T):
    """(lo, hi) pairs that cut 32-step chunks, the data bits among them."""
    return [(0, T), (5, 37), (31, 65), (K - 1, K - 1 + 64), (T - 1, T), (7, 7)]


def _check_forms(pc, walk, dec, end, t_real, want_bits, *extra):
    """Every bits and bytes cut of ``walk`` against the JAX walk outputs
    ``want_bits [B, t_real]``; ``out=`` a view with a row stride."""
    for lo, hi in _cuts(pc.K, t_real):
        if hi > t_real:
            continue
        got = walk(pc, dec, end, t_real, *extra, "bits", lo, hi)
        np.testing.assert_array_equal(got.numpy(), want_bits[:, lo:hi])
        n = (hi - lo) // 8 * 8
        got = walk(pc, dec, end, t_real, *extra, "bytes", lo, lo + n)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jbits.bits_to_bytes(want_bits[:, lo:lo + n])))
    big = torch.full((B, t_real + 20), 7, dtype=torch.uint8)
    view = big[:, 10:10 + t_real - 3]
    assert walk(pc, dec, end, t_real, *extra, "bits", 3, t_real, out=view) is view
    np.testing.assert_array_equal(view.numpy(), want_bits[:, 3:])
    assert (big[:, :10] == 7).all() and (big[:, 10 + t_real - 3:] == 7).all()


@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI29], ids=["k7", "k9"])
def test_chainback_tb_forms_match_pallas(jc):
    """State-order words of the JAX ``acs_update_tb``, walked whole and from
    an odd ``t_real``."""
    jn = J.soft8_spec(jc.R)
    s, m0 = _inputs(jc, jn, 3)
    T = s.shape[0]
    Tp = -(-T // jk.pick_time_block(jc, B)) * jk.pick_time_block(jc, B)
    _, jd = jk.acs_update_tb(jc, jn, jnp.asarray(m0), jnp.asarray(_padded(s, Tp)), T, True)
    end = np.random.default_rng(4).integers(0, jc.num_states, size=(1, B)).astype(np.int32)
    pc, dec = ported(jc), _as_torch(jd)
    for t_real in (T, T - 3):
        want = np.asarray(jdispatch.unpack_bit_words(
            jk.chainback_tb(jc, jd, jnp.asarray(end), t_real, True), t_real))
        _check_forms(pc, pk.chainback_tb, dec, torch.from_numpy(end), t_real, want)
        # The words form is what it was.
        got = pk.chainback_tb(pc, dec, torch.from_numpy(end), t_real)
        np.testing.assert_array_equal(
            np.asarray(jdispatch.unpack_bit_words(jnp.asarray(got.numpy().view(np.uint32)),
                                                  t_real)), want)


@pytest.mark.parametrize("t0", [1, 5])
def test_chainback_inplace_forms_match_pallas(t0):
    """Position-packed words of the JAX ``acs_update_inplace`` from a window
    ``t0`` that is not a multiple of K-1, walked whole and from an odd
    ``t_real``."""
    jc, jn = J.VITERBI27, J.soft8_spec(2)
    s, m0 = _inputs(jc, jn, 30 + t0)
    T = s.shape[0]
    Tp = jip.pad_time_inplace(jc, T, B)
    _, jd = jip.acs_update_inplace(jc, jn, jnp.asarray(m0[jip.rot_perm(jc, t0)]),
                                   jnp.asarray(_padded(s, Tp)), T, t0, True)
    jd = jd[:-(-T // jip.CB_TB) * jip.CB_TB]
    end = np.random.default_rng(t0).integers(0, jc.num_states, size=(1, B)).astype(np.int32)
    pc, dec = ported(jc), _as_torch(jd)
    for t_real in (T, T - 5):
        want = np.asarray(jdispatch.unpack_bit_words(
            jip.chainback_inplace(jc, jd, jnp.asarray(end), t_real, True, t0), t_real))
        _check_forms(pc, pip.chainback_inplace, dec, torch.from_numpy(end), t_real, want, t0)


def _random_words(jc, Bn, T, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(Bn, T, jc.decision_words), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("rotated", [False, True], ids=["state-order", "position-packed"])
def test_k15_forms_match_jnp_walk(rotated):
    """K=15 (the walk's candidate-fetch form on a card): data bits and bytes
    against the JAX ``jnp`` walk, from a per-frame end state."""
    jc = J.VITERBI615
    pc, nbits = ported(jc), 32
    T = nbits + jc.K - 1 + 3
    words = _random_words(jc, 3, T, 15)
    end = np.array([5, 16000, 0], dtype=np.int32)
    want, _ = jcb.chainback_bits(jc, jnp.asarray(words), nbits + 3, jnp.asarray(end), rotated)
    want = np.asarray(want)
    dec = torch.from_numpy(words.view(np.int32)).permute(1, 2, 0)
    walk, extra = (pip.chainback_inplace, (0,)) if rotated else (pk.chainback_tb, ())
    lo = jc.K - 1
    got = walk(pc, dec, torch.from_numpy(end), T, *extra, "bits", lo, T)
    np.testing.assert_array_equal(got.numpy(), want)
    got = walk(pc, dec, torch.from_numpy(end), T, *extra, "bytes", lo, lo + nbits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbits.bits_to_bytes(want[:, :nbits])))


def _tied_metrics(S, Bn, seed):
    """``[S, Bn]`` int32 with many equal minima: small values, a frame all
    equal, a frame whose minimum sits at the last state and again at the
    first."""
    m = np.random.default_rng(seed).integers(0, 3, size=(S, Bn)).astype(np.int32)
    m[:, 1] = 9
    m[:, 2] = 5
    m[[0, S - 1], 2] = 1
    return m


@pytest.mark.parametrize("phase", [0, 1, 4])
@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI615], ids=["k7", "k15"])
def test_argmin_takes_the_first_state(jc, phase):
    """The argmin form's end state: ``jnp.argmin`` of the state-order
    metrics, from metrics in position space of a rotation phase, ``[S, B]``
    or as the view of a batch-major ``[B, S]``; a walk from it equals the
    walk from the JAX argmin's states."""
    pc, S = ported(jc), jc.num_states
    m_state = _tied_metrics(S, 6, phase)
    want = np.asarray(jnp.argmin(jnp.asarray(m_state.T), axis=-1))
    m_pos = np.ascontiguousarray(m_state[jip.rot_perm(jc, phase)])
    for m in (torch.from_numpy(m_pos), torch.from_numpy(np.ascontiguousarray(m_pos.T)).T):
        np.testing.assert_array_equal(pk.argmin_states(pc, m, phase).numpy(), want)
    if jc.K > 7:
        return
    T = 50
    words = _random_words(jc, 6, T, 40 + phase)
    dec = torch.from_numpy(words.view(np.int32)).permute(1, 2, 0)
    want_bits, _ = jcb.chainback_bits(jc, jnp.asarray(words), T - 6, jnp.asarray(want))
    for walk, extra, rotated in ((pk.chainback_tb, (), False), (pip.chainback_inplace, (3,), True)):
        got = walk(pc, dec, None, T, *extra, "bits", 0, T, metrics=torch.from_numpy(m_pos),
                   metrics_phase=phase)
        ref = walk(pc, dec, torch.from_numpy(want.astype(np.int32)), T, *extra, "bits", 0, T)
        assert torch.equal(got, ref)
        if not rotated:
            np.testing.assert_array_equal(got.numpy()[:, 6:], np.asarray(want_bits))


@pytest.mark.parametrize("rotated", [False, True], ids=["state-order", "position-packed"])
def test_start_step_equals_the_zeroed_walk(rotated):
    """A frame that starts at step ``s < t_real`` walks as the JAX walk of
    its words zeroed from ``s`` on, from state 0; the others from their end
    state.  Bits, bytes and words forms."""
    jc = J.VITERBI27
    pc, T = ported(jc), 70
    words = _random_words(jc, 5, T, 77 + rotated)
    start = np.array([T, 40, 0, 33, T - 1], dtype=np.int32)
    end = np.array([17, 3, 9, 60, 44], dtype=np.int32)
    zeroed = np.where(np.arange(T)[None, :, None] < start[:, None, None], words, 0).astype(np.uint32)
    jend = np.where(start < T, 0, end).astype(np.int32)
    want, _ = jcb.chainback_bits(jc, jnp.asarray(zeroed), T - 6, jnp.asarray(jend), rotated)
    want = np.asarray(want)
    dec = torch.from_numpy(words.view(np.int32)).permute(1, 2, 0)
    walk, extra = (pip.chainback_inplace, (0,)) if rotated else (pk.chainback_tb, ())
    kw = {"start": torch.from_numpy(start)}
    got = walk(pc, dec, torch.from_numpy(end), T, *extra, "bits", 6, T, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    got = walk(pc, dec, torch.from_numpy(end), T, *extra, "bytes", 6, 6 + 64, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbits.bits_to_bytes(want[:, :64])))
    words_form = walk(pc, dec, torch.from_numpy(end), T, *extra, **kw)
    zw = torch.from_numpy(zeroed.view(np.int32)).permute(1, 2, 0)
    assert torch.equal(words_form, walk(pc, zw, torch.from_numpy(jend), T, *extra))


def test_forms_refuse_what_the_kernel_does_not_take():
    pc = ported(J.VITERBI27)
    dec = torch.zeros((40, 2, 3), dtype=torch.int32)
    for bad in (dict(form="nibbles"), dict(form="bits", lo=5, hi=41), dict(form="bytes", hi=12),
                dict(form="bits", lo=6, hi=5)):
        with pytest.raises(ValueError):
            pk.chainback_tb(pc, dec, 0, 40, **bad)


# -- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [  # K, R, B, T, t_real, t0
    (7, 2, 513, 300, 299, 3), (7, 2, 9, 70, 70, 0), (9, 2, 130, 200, 171, 5),
    (5, 2, 33, 100, 77, 1), (11, 2, 17, 150, 141, 7), (15, 6, 10, 80, 80, 4),
    (15, 6, 3, 61, 45, 13),
]


def _code(K, R):
    from ka9q_viterbi_comparison_tpu_torch.configs import CodeSpec
    polys = {7: (0o171, 0o133), 9: (0o561, 0o753), 5: (0o23, 0o35), 11: (0o3345, 0o2671),
             15: (0o42631, 0o47245, 0o56507, 0o73363, 0o77267, 0o64537)}[K]
    return CodeSpec(f"k{K}r{R}", K, R, polys[:R])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: f"K{c[0]}B{c[2]}t{c[4]}")
@pytest.mark.parametrize("rotated", [False, True], ids=["tb", "inplace"])
def test_cuda_forms_match_plain(case, rotated, cuda_device):
    """Every output form, end-state form and start step of the kernel
    against its plain version, on random words: staged (K <= 9) and
    candidate fetches (K >= 10), ragged batches, odd ``t_real``, cuts that
    split chunks, a row stride, metrics ``[S, B]`` and ``[B, S]`` with ties,
    one launch a call under the route's counter."""
    K, R, Bn, T, t_real, t0 = case
    pc = _code(K, R)
    rng = np.random.default_rng(K * 1000 + Bn)
    dec = torch.from_numpy(rng.integers(-2**31, 2**31, size=(T, pc.decision_words, Bn))
                           .astype(np.int32)).to(cuda_device)
    S = pc.num_states
    m = torch.from_numpy(rng.integers(0, 4, size=(S, Bn)).astype(np.int32)).to(cuda_device)
    ends = [int(rng.integers(0, S)),
            torch.from_numpy(rng.integers(0, S, size=(1, Bn)).astype(np.int32)).to(cuda_device),
            torch.tensor(min(S - 1, 200), dtype=torch.uint8, device=cuda_device)]
    start = torch.from_numpy(rng.integers(0, t_real + 30, size=Bn).astype(np.int32)).to(cuda_device)
    walk, ref, extra, name = ((pip.chainback_inplace, pip.chainback_inplace_ref, (t0,),
                               "chainback_inplace") if rotated else
                              (pk.chainback_tb, pk.chainback_tb_ref, (), "chainback_tb"))
    lo = min(K - 1, t_real)
    cuts = [("words", 0, None), ("bits", 0, t_real), ("bits", 5, t_real - 2),
            ("bytes", lo, lo + (t_real - lo) // 8 * 8), ("bytes", 3, 3 + (t_real - 3) // 8 * 8)]
    phase = (t0 + t_real) % (K - 1) if rotated else 0
    for form, a, b in cuts:
        for kw in [dict(endstate=e) for e in ends] + [
                dict(endstate=None, metrics=m, metrics_phase=phase),
                dict(endstate=None, metrics=m.T.contiguous().T, metrics_phase=phase),
                dict(endstate=ends[1], start=start)]:
            end = kw.pop("endstate")
            n = _build.LAUNCHES[name]
            got = walk(pc, dec, end, t_real, *extra, form, a, b, **kw)
            assert _build.LAUNCHES[name] == n + 1
            want = ref(pc, dec.cpu(), end.cpu() if isinstance(end, torch.Tensor) else end, t_real,
                       *extra, form, a, b, **{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                                              for k, v in kw.items()})
            got = got.cpu()
            if form == "words":
                got, want = got[:-(-t_real // 32)], want[:-(-t_real // 32)]
            assert torch.equal(got, want), (form, a, b, sorted(kw))
    big = torch.full((Bn, t_real + 40), 7, dtype=torch.uint8, device=cuda_device)
    view = big[:, 20:20 + t_real - 5]
    walk(pc, dec, ends[0], t_real, *extra, "bits", 5, t_real, out=view)
    assert torch.equal(view.cpu(), ref(pc, dec.cpu(), ends[0], t_real, *extra, "bits", 5, t_real))
    assert (big[:, :20] == 7).all() and (big[:, 20 + t_real - 5:] == 7).all()


SEGMENT_CASES = [  # K, B, T or frame bytes, noisy (3 dB words of the plain ACS)
    (3, 130, 2000, False), (5, 9, 700, False), (7, 512, 8198, False), (9, 130, 4104, False),
    (7, 64, 1024, True), (9, 64, 512, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEGMENT_CASES,
                         ids=lambda c: f"K{c[0]}B{c[1]}" + ("noisy" if c[3] else f"T{c[2]}"))
@pytest.mark.parametrize("rotated", [False, True], ids=["tb", "inplace"])
def test_cuda_segments_match_plain(case, rotated, cuda_device):
    """The staged walk's segments (K <= 9) on the card against the serial
    plain walk: every output and end-state form, a start step, a rotation
    phase; random words, on which most guesses fail and segments are walked
    again in runs, and 3 dB words, on which few are.  ``rewalk_stats``: the
    segments each launch planned, and those the kernel walked again, equal
    to the plain replay's count (``test_torch_walk_segments.py``) and above
    zero on random words."""
    from test_torch_walk_segments import code_k, form_calls, noisy_words, random_words, \
        replay_segments
    K, Bn, T, noisy = case
    pc = code_k(K)
    p0 = (K + 3) % (K - 1) if rotated else 0
    if noisy:
        dec, _ = noisy_words(pc, Bn, T, rotated, seed=K)
        p0, T = 0, dec.shape[0]
    else:
        dec = random_words(pc, T + 5, Bn, seed=K * 1000 + Bn)
    n = pk.walk_plan(K, Bn, T)[0]
    dev_dec = dec.to(cuda_device)
    walk = (lambda *a, **kw: pip.chainback_inplace(*a[:4], p0, *a[4:], **kw)) if rotated else \
        pk.chainback_tb
    rewalked = 0
    for end, form, kw in form_calls(pc, Bn, T, rotated, p0, seed=T):
        want = pk.walk_ref(pc, dec, end, T, rotated, p0, form, **kw)
        replayed, count = replay_segments(pc, dec, end, T, rotated, p0, form, **kw)
        assert torch.equal(replayed, want)
        on_card = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
        before = pk.rewalk_stats()
        got = walk(pc, dev_dec, end.to(cuda_device) if isinstance(end, torch.Tensor) else end, T,
                   form, **on_card)
        after = pk.rewalk_stats()
        assert torch.equal(got.cpu(), want), (form, sorted(kw))
        assert after["segments"] - before["segments"] == Bn * n
        assert after["rewalked"] - before["rewalked"] == count, (form, sorted(kw))
        rewalked += count
    assert noisy or rewalked > 0


@pytest.mark.cuda
def test_cuda_refuses_a_bad_out(cuda_device):
    pc = _code(7, 2)
    dec = torch.zeros((40, 2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="out"):
        pk.chainback_tb(pc, dec, 0, 40, "bits", 0, 40,
                        out=torch.empty((3, 40), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="out"):
        pk.chainback_tb(pc, dec, 0, 40, "bits", 0, 40,
                        out=torch.empty((40, 3), dtype=torch.uint8, device=cuda_device).T)

