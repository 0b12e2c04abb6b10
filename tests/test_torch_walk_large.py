"""The port's K > 15 walks against the JAX package.

On the CPU each wrapper runs its kernel's plain version: the table walk
(``walk.chainback_plane_bits`` / ``chainback_planes``, plain version
``radix_planes.chainback_plane_bits``) and the words walk
(``kernels.chainback_tb``, which takes any K up to 24, plain version
``kernels.chainback_tb_ref``, here in the kernel's ``[Tp, W, B]`` view of
batch-major words).  They are held
against the JAX package's ``ops/radix_planes.py`` ``chainback_plane_bits``
and ``ops/chainback.py`` ``chainback`` on random decision words (every bit
random, so every survivor path is possible) at ICE soft8 with 8-byte frames
(T = 87, the f8 and f4 tables anchored at K-1 = 23, as ``phase_fns`` walks
them) and at K=16; the routes that reach the words walk above K=15
(``dispatch.chainback``, ``ViterbiDecoder``, the time-block walk, the
stream's release walk) against the portable path.  Cases marked ``cuda``
hold each kernel against its plain version on the card.  Tolerance: exact
equality (bit operations)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import chainback as jcb, radix_planes as jrp
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, words_from_numpy
from ka9q_viterbi_comparison_tpu_torch.ops import acs as pacs
from ka9q_viterbi_comparison_tpu_torch.ops import chainback as pcb, radix_planes as prp
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, dispatch, kernels, walk
from ka9q_viterbi_comparison_tpu_torch.parallel import timeblock
from ka9q_viterbi_comparison_tpu_torch.utils.bits import unpack_words_to_bits

K16 = J.CodeSpec("k16r2", K=16, R=2, polys=(0o123456, 0o165473))
K17 = P.CodeSpec("k17r2", 17, 2, (0o345567, 0o251331))
ICE_T, ICE_ANCHOR = 87, 23  # 8-byte frames: 64 + 23 steps; the walk stops at K-1


def ported(jc):
    return code_from_fields(jc.name, jc.K, jc.R, jc.polys)


@functools.lru_cache(maxsize=None)
def random_words(K: int, T: int, B: int, seed: int) -> np.ndarray:
    """Batch-major ``[B, T, W]`` uint32, every bit random."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(B, T, 1 << (K - 6)), dtype=np.uint32)


def ice_tables(width: int):
    """Random ICE words of one frame (91 MB), time-major on both sides, and
    the port's tables of width ``width`` at anchor 23."""
    words = random_words(24, ICE_T, 1, 24)
    w_tm = words_from_numpy(words).transpose(0, 1)
    tabs = prp.build_plane_tables(P.VITERBI224, w_tm, ICE_ANCHOR, None, width)
    return words, w_tm, tabs


@pytest.mark.parametrize("width", [8, 4], ids=["f8", "f4"])
def test_ice_table_walk_matches_jax(width):
    """Words and tables, and the table alone (the fields kernels' route):
    bits, end state and bytes equal the JAX table walk's, for end states 0
    and 0x5A5A5A (bit 22 set: the walk enters at the top half)."""
    words, w_tm, tabs = ice_tables(width)
    jw_tm = jnp.asarray(words.transpose(1, 0, 2))
    name = f"f{width}"
    jtabs = {k: jnp.asarray(v.numpy().view(np.uint32)) for k, v in tabs.items()}
    for end in (0, 0x5A5A5A):
        bits, state = walk.chainback_plane_bits(P.VITERBI224, w_tm, tabs, 64, end, ICE_ANCHOR)
        jbits, jstate = jrp.chainback_plane_bits(J.VITERBI224, jw_tm, jtabs, 64, end, ICE_ANCHOR)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
        only, jonly = {name: tabs[name]}, {name: jtabs[name]}
        got = walk.chainback_planes(P.VITERBI224, None, only, 64, end, ICE_ANCHOR)
        want = jrp.chainback_planes(J.VITERBI224, None, jonly, 64, end, ICE_ANCHOR)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert torch.equal(got, walk.chainback_planes_ref(P.VITERBI224, None, only, 64, end,
                                                          ICE_ANCHOR))
    # The plain walk over the same words decodes the same bits.
    plain, _ = pcb.chainback_bits(P.VITERBI224, words_from_numpy(words), 64, 0)
    assert torch.equal(walk.chainback_plane_bits(P.VITERBI224, w_tm, tabs, 64, 0, ICE_ANCHOR)[0],
                       plain)


def test_ice_words_walk_matches_jax():
    """``dispatch.chainback`` at ICE (the words walk over the batch-major
    words where they lie) equals the JAX ``chainback``; the kernel-layout
    walk's outputs equal the portable walk's at every step."""
    words = random_words(24, ICE_T, 1, 24)
    pw = words_from_numpy(words)
    end = 0x2ABCDE
    want = jcb.chainback(J.VITERBI224, jnp.asarray(words), 64, end)
    got = dispatch.chainback(P.VITERBI224, pw, 64, end)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ends = torch.full((1, 1), end, dtype=torch.int32)
    packed = kernels.chainback_tb(P.VITERBI224, pw.permute(1, 2, 0), ends, ICE_T)
    assert packed.shape == (-(-ICE_T // 32), 1)
    ks, _ = pcb.walk(P.VITERBI224, pw, end)
    assert torch.equal(unpack_words_to_bits(packed.T)[:, :ICE_T], ks.to(torch.uint8))


def test_k16_walks_match_jax():
    """K=16, three frames of 50 steps: the words walk through
    ``dispatch.chainback`` and the table walk at both widths equal the JAX
    walks."""
    pc = ported(K16)
    words = random_words(16, 50, 3, 16)
    pw = words_from_numpy(words)
    for end in (0, 31337):
        want = jcb.chainback(K16, jnp.asarray(words), 32, end)
        np.testing.assert_array_equal(dispatch.chainback(pc, pw, 32, end).numpy(),
                                      np.asarray(want))
    w_tm = pw.transpose(0, 1)
    for width in (4, 8):
        tabs = prp.build_plane_tables(pc, w_tm, K16.K - 1, None, width)
        jtabs = {k: jnp.asarray(v.numpy().view(np.uint32)) for k, v in tabs.items()}
        bits, state = walk.chainback_plane_bits(pc, w_tm, tabs, 32, 777, K16.K - 1)
        jbits, jstate = jrp.chainback_plane_bits(K16, jnp.asarray(words.transpose(1, 0, 2)), jtabs,
                                                 32, 777, K16.K - 1)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))


def test_routes_take_the_words_walk_above_k15():
    """``supports_chainback`` covers every K a code may have (up to 24,
    ``chainback_tb``'s bound); ``phase_fns`` keeps the plane tables above
    K=15."""
    assert kernels.TB_MAX_K == 24
    assert all(dispatch.supports_chainback(c) for c in (P.VITERBI615, ported(K16), K17,
                                                         P.VITERBI224))
    fns = dispatch.phase_fns(K17, P.soft8_spec(2), 32, 2, "cpu")
    sym = torch.zeros((2, 32 + 16, 2), dtype=torch.int32)
    _, table, _ = fns[1](fns[0](2), fns[3](sym))
    assert set(table) == {"f8"}


def _k17_frames(B, n_bytes, seed):
    from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames

    rng = np.random.default_rng(seed)
    numeric = P.soft8_spec(2)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = encode_frames(K17, numeric, torch.from_numpy(data)).reshape(B, -1, 2)
    noise = torch.from_numpy(rng.integers(-3, 4, size=tuple(sym.shape)).astype(np.int32))
    return data, torch.clamp(sym.to(torch.int32) + noise, numeric.soft_low, numeric.soft_high)


def test_decoder_time_blocks_and_stream_above_k15():
    """At K=17 on the CPU: ``ViterbiDecoder(backend="cuda")`` decodes the
    bytes of ``backend="torch"``; the time-block walk over batch-major words
    equals the portable walk; a stream's pushes and flush equal the torch
    stream's."""
    numeric = P.soft8_spec(2)
    data, sym = _k17_frames(3, 4, 17)
    outs = []
    for be in ("cuda", "torch"):
        dec = P.ViterbiDecoder(K17, numeric, 3, be, device="cpu")
        dec.update(sym)
        outs.append(dec.chainback(32))
    assert torch.equal(*outs)
    _, words, _ = dispatch.acs_update(K17, numeric, pacs.init_metrics(K17, numeric, 3), sym)
    end = torch.tensor([5, 70000, 0], dtype=torch.int32)
    got = timeblock._walk_bits(K17, words, end, False)
    assert torch.equal(got, pcb.walk(K17, words, end)[0].to(torch.uint8))
    streams = [P.StreamingDecoder(K17, numeric, 3, traceback_depth=20, backend=be, device="cpu")
               for be in ("cuda", "torch")]
    released = [[s.push(sym[:, :20]), s.push(sym[:, 20:]), s.flush()] for s in streams]
    for a, b in zip(*released):
        assert torch.equal(a, b)


def test_plan_check_and_end_states():
    """The wrapper refuses tables too short for the walk's plan, and reads
    an end state as an int, an int32 ``[B]`` or a uint8 0-d tensor."""
    tabs = {"f8": torch.zeros((2, 8, 1, 32), dtype=torch.int32)}
    walk._check_plan(tabs, None, 16 + 10, 10, 8)  # two full windows
    with pytest.raises(ValueError, match="rows of f8"):
        walk._check_plan(tabs, None, 24 + 10, 10, 8)
    with pytest.raises(ValueError, match="rows of f4"):
        walk._check_plan(tabs, torch.zeros((30, 1, 32), dtype=torch.int32), 30, 10, 8)
    with pytest.raises(ValueError, match="rows of words"):
        walk._check_plan(dict(tabs, f4=torch.zeros((5, 4, 1, 32), dtype=torch.int32)), None,
                         31, 10, 8)
    assert walk._end_args(7, 3, torch.device("cpu"))[1:4] == (0, 0, 7)
    assert walk._end_args(torch.arange(3, dtype=torch.int32), 3, torch.device("cpu"))[1:3] == (1, 1)
    assert walk._end_args(torch.tensor(9, dtype=torch.uint8), 3, torch.device("cpu"))[1:3] == (2, 0)
    with pytest.raises(ValueError, match="1 or 3 values"):
        walk._end_args(torch.zeros(2, dtype=torch.int32), 3, torch.device("cpu"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", [45, 80, 87, 83])
def test_cuda_plane_walk(cuda_device, T):
    """The table walk kernel against its plain version on random K=17
    words: both widths and anchors, bits and bytes, three kinds of end
    state, one launch a call."""
    w_tm = words_from_numpy(random_words(17, T, 5, T)).transpose(0, 1).contiguous().cuda()
    ends = (0, torch.arange(5, dtype=torch.int32, device="cuda") * 9001,
            torch.tensor(201, dtype=torch.uint8, device="cuda"))
    for anchor in (0, 16):
        for width in (4, 8):
            tabs = prp.build_plane_tables(K17, w_tm, anchor, None, width)
            nbits = (T - 16) // 8 * 8
            for end in ends:
                n = _build.LAUNCHES["chainback_planes"]
                got = walk.chainback_plane_bits(K17, w_tm, tabs, nbits, end, anchor)
                assert _build.LAUNCHES["chainback_planes"] == n + 1
                want = prp.chainback_plane_bits(K17, w_tm, tabs, nbits, end, anchor)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                assert torch.equal(walk.chainback_planes(K17, w_tm, tabs, nbits, end, anchor),
                                   walk.chainback_planes_ref(K17, w_tm, tabs, nbits, end, anchor))


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,T", [(16, 3, 50), (17, 9, 87), (16, 8, 1), (24, 2, 87)])
def test_cuda_words_walk(cuda_device, K, B, T):
    """``chainback_tb``'s kernel above K=15 against its plain version, over
    batch-major words (a permuted view) and ``[Tp, W, B]``."""
    code = P.VITERBI224 if K == 24 else (K17 if K == 17 else ported(K16))
    w_bt = words_from_numpy(random_words(K, T, B, K + T)).cuda()
    end = torch.arange(B, dtype=torch.int32, device="cuda").reshape(1, B) * 7919 % code.num_states
    for dec in (w_bt.permute(1, 2, 0), w_bt.permute(1, 2, 0).contiguous()):
        n = _build.LAUNCHES["chainback_tb"]
        got = kernels.chainback_tb(code, dec, end, T)
        assert _build.LAUNCHES["chainback_tb"] == n + 1
        assert torch.equal(got, kernels.chainback_tb_ref(code, dec, end, T))
