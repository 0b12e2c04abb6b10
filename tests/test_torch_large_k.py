"""The state-blocked large-K kernels of the port's second slice.

On the CPU, the plain versions (``acs_update_large_ref`` and
``acs_update_large2_ref``, which the wrappers run for CPU tensors) are held
against the JAX package's ``large_k.acs_update_large`` and
``large_k2.acs_update_large2`` in interpret mode: metrics, words and offset
bit-equal, on numpy-made noisy symbols.  ``renorm_schedule`` is held against
the storage type and renormalisation interval that the JAX function traces
to.  Tests marked ``cuda`` hold each CUDA kernel against its plain version
and skip where there is no card.  Tolerance: exact equality (integer
arithmetic)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import large_k as jlk, large_k2 as jlk2
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, large_k as plk, large_k2 as plk2

K8 = J.CodeSpec("k8r2", 8, 2, (0o357, 0o251))


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def inputs(jc, jn, B, n_bytes, noise, seed, lift=(0, 1)):
    """Noisy symbols ``[B, T, R]`` and metrics ``[B, S]``: the reset metrics
    plus a per-state random lift in ``[lift[0], lift[1])``, so the entry
    shift is ``>= lift[0]``."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(B, -1, jc.R)
    sym = np.clip(sym + rng.integers(-noise, noise + 1, size=sym.shape), jn.soft_low, jn.soft_high)
    m0 = np.asarray(jacs.init_metrics(jc, jn, B)) + rng.integers(*lift, size=(B, jc.num_states))
    return sym.astype(np.int32), m0.astype(np.int32)


def assert_same(got, want):
    """``(metrics, words, offset)`` of the port and of the JAX package."""
    m, w, off = got
    jm, jw, joff = want
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(w.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))


def both(jc, jn, fn, sym, m0, **kw):
    pc, pn = ported(jc, jn)
    jfn, pfn = {"large": (jlk.acs_update_large, plk.acs_update_large),
                "large2": (jlk2.acs_update_large2, plk2.acs_update_large2)}[fn]
    want = jfn(jc, jn, jnp.asarray(m0), jnp.asarray(sym), True, **kw)
    got = pfn(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym), **kw)
    return got, want


@pytest.mark.parametrize("fn", ["large", "large2"])
@pytest.mark.parametrize("jc,n_bytes", [(J.VITERBI29, 16), (J.VITERBI615, 4), (K8, 8)],
                         ids=["viterbi29", "viterbi615", "k8_odd_tail"])
def test_matches_jax(jc, n_bytes, fn):
    """Noisy soft8 frames from lifted metrics (a non-zero entry shift); the
    K=8 code has an odd step count, so ``large2`` ends in its single-step
    tail."""
    jn = J.soft8_spec(jc.R)
    sym, m0 = inputs(jc, jn, 2, n_bytes, 4, seed=jc.K, lift=(3, 40))
    if jc is K8:
        assert sym.shape[1] % 2 == 1
    got, want = both(jc, jn, fn, sym, m0)
    assert (got[2] >= 3).all()
    assert_same(got, want)


@pytest.mark.parametrize("fn", ["large", "large2"])
def test_blockwise_resume_bump(fn):
    """Incoming metrics lifted by 30000 (as if a long stream had run
    before): the whole bump comes back as the offset."""
    jc, jn = J.VITERBI29, J.soft8_spec(2)
    sym, m0 = inputs(jc, jn, 2, 16, 3, seed=2)
    bump = 30_000
    got, want = both(jc, jn, fn, sym, m0 + bump)
    np.testing.assert_array_equal(got[2].numpy(), bump)
    assert_same(got, want)


@pytest.mark.parametrize("steps", [136, 92, 93], ids=["68_pairs", "46_pairs", "46_pairs_odd"])
def test_inscan_renorm_fires(steps):
    """Offset-binary symbols at K=9: the whole block overflows int16, so
    the pair kernel renormalises every rn = 23 pairs.  68 pairs: twice,
    mid-block; 46 pairs: after the last pair too, so the returned metrics
    already hold that shift (their minimum is 0); 46 pairs and the odd tail:
    the tail's entry shift follows it."""
    jc, jn = J.VITERBI29, J.ka9q_offset_binary_spec()
    pc, pn = ported(jc, jn)
    sym, m0 = inputs(jc, jn, 2, 16, 90, seed=5)
    sym = np.ascontiguousarray(sym[:, :steps])
    assert plk2.renorm_schedule(pc, pn, steps) == (torch.int16, 23)
    got, want = both(jc, jn, "large2", sym, m0)
    assert (got[2] > 0).all()
    assert_same(got, want)
    if steps == 92:
        assert (got[0].amin(dim=1) == 0).all()
    # Against the port's own un-renormalised path: only the split differs.
    m1, w1, off1 = plk.acs_update_large_ref(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym))
    assert torch.equal(w1, got[1]) and (off1 == 0).all()
    assert torch.equal(got[0] + got[2][:, None], m1)


def test_time_major_words():
    jc, jn = J.VITERBI615, J.soft16_spec(6)
    sym, m0 = inputs(jc, jn, 2, 2, 100, seed=6)
    got, want = both(jc, jn, "large2", sym, m0, time_major=True)
    assert_same(got, want)
    pc, pn = ported(jc, jn)
    _, w_bm, _ = plk2.acs_update_large2(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym))
    assert torch.equal(got[1], w_bm.transpose(0, 1))


def test_k24_one_pair_and_tail():
    """ICE (K=24, 2^23 states): one pair and the odd tail, B=1."""
    jc, jn = J.VITERBI224, J.soft8_spec(2)
    rng = np.random.default_rng(24)
    sym = rng.integers(-3, 4, size=(1, 3, 2)).astype(np.int32)
    m0 = np.asarray(jacs.init_metrics(jc, jn, 1)) + rng.integers(1, 9, size=(1, jc.num_states))
    got, want = both(jc, jn, "large2", sym, m0.astype(np.int32))
    assert_same(got, want)


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _walk(inner)


def jax_schedule(jc, jn, T, metric_dtype):
    """The storage type and ``rn`` the JAX ``acs_update_large2`` traces to:
    the dtype of its pair scan's metric carry, and ``rn - 1`` as the literal
    its in-scan ``cond`` predicate compares with (no ``cond``: rn = 0)."""
    sds = jax.ShapeDtypeStruct
    jp = jax.make_jaxpr(
        lambda m, y: jlk2.acs_update_large2.__wrapped__(jc, jn, m, y, True, metric_dtype))(
        sds((1, jc.num_states), jnp.int32), sds((1, T, jc.R), jnp.int32))
    carry_shape = (1, 32, jc.num_states // 32)
    scan = next(e for e in _walk(jp.jaxpr) if e.primitive.name == "scan"
                and e.invars[e.params["num_consts"]].aval.shape == carry_shape)
    mdt = scan.invars[scan.params["num_consts"]].aval.dtype
    body = scan.params["jaxpr"].jaxpr.eqns
    rn = 0
    if any(e.primitive.name == "cond" for e in body):
        eq = next(e for e in body if e.primitive.name == "eq"
                  and isinstance(e.invars[1], jcore.Literal))
        rn = int(eq.invars[1].val) + 1
    return {np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32}[np.dtype(mdt)], rn


SPECS = ["ka9q_offset_binary_spec", "soft16_spec", "soft8_spec", "hard8_spec"]


@pytest.mark.parametrize("jc", [J.VITERBI29, J.VITERBI49, J.VITERBI615, J.VITERBI224],
                         ids=lambda c: c.name)
def test_renorm_schedule_matches_jax(jc):
    """Every numeric spec at a short block, the Cassini frame (2062 steps)
    and a long stream block, the last also with int16 storage forced.  (The
    K=7 codes have no large-K pair route: the JAX function refuses their
    state block, and so does the port.)"""
    for spec in SPECS:
        jn = getattr(J, spec)() if spec == "ka9q_offset_binary_spec" else getattr(J, spec)(jc.R)
        pc, pn = ported(jc, jn)
        for T, metric_dtype in ((46, None), (2062, None), (40000, None), (40000, "int16")):
            try:
                want = jax_schedule(jc, jn, T, metric_dtype)
            except ValueError:
                with pytest.raises(ValueError, match="int16 metrics cannot hold"):
                    plk2.renorm_schedule(pc, pn, T, metric_dtype)
                continue
            assert plk2.renorm_schedule(pc, pn, T, metric_dtype) == want, (spec, T)
            if metric_dtype is None and not want[1]:
                assert want[0] == plk.metric_dtype_for(pc, pn, T)


def test_cassini_soft8_schedule():
    """At a full Cassini soft8 frame the pair kernel renormalises every 394
    pairs (twice a frame); soft16 and offset-binary stay int32 with none."""
    pc = ported(J.VITERBI615, J.soft8_spec(6))[0]
    T = pc.transmit_bits(256)
    assert T == 2062
    assert plk2.renorm_schedule(pc, ported(J.VITERBI615, J.soft8_spec(6))[1], T) == (torch.int16, 394)
    for jn in (J.soft16_spec(6), J.ka9q_offset_binary_spec()):
        assert plk2.renorm_schedule(pc, ported(J.VITERBI615, jn)[1], T) == (torch.int32, 0)


def test_state_block_and_small_k_refused():
    pc, pn = ported(J.VITERBI27, J.soft8_spec(2))
    assert plk.pick_state_block(pc) == jlk.pick_state_block(J.VITERBI27)
    assert plk.pick_state_block(ported(J.VITERBI224, J.soft8_spec(2))[0]) == jlk.MAX_BLOCK
    m = torch.zeros((1, 64), dtype=torch.int32)
    s = torch.zeros((1, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="K=7 < 8"):
        plk2.acs_update_large2(pc, pn, m, s)
    assert plk.acs_update_large(pc, pn, m, s)[1].shape == (1, 4, 2)


@pytest.mark.parametrize("K,batch,blocks", [
    (8, 1, 1), (9, 64, 1), (12, 8, 1), (13, 8, 1), (14, 8, 4), (14, 64, 2), (14, 100, 1),
    (15, 1, 4), (15, 32, 4), (15, 64, 2), (15, 128, 1), (15, 256, 1), (16, 8, 4), (16, 64, 2),
    (16, 100, 2), (17, 8, 4), (17, 64, 4), (18, 8, 0), (24, 8, 0)])
def test_chip_blocks(K, batch, blocks):
    """Blocks a frame of the on-chip pair kernel, by trellis and batch: one
    up to K=13; from K=14 (Cassini: 15) four blocks a frame up to 32 frames,
    two up to 64 (the decoder's path), else the fewest that fit; from K=18
    the frame no longer fits and the block streams.  Where it fits, a
    block's two metric buffers stay within the card's 227 KB of shared
    memory a block, and its quads fill at least a warp and a pair's table
    entries (R=3: 16)."""
    pc = ported(J.CodeSpec("k", K, 3, tuple((1 << (K - 1)) | (2 * r + 1) for r in range(3))),
                J.soft8_spec(3))[0]
    assert plk2.chip_blocks(pc, batch) == blocks
    if blocks:
        assert 2 * 4 * pc.num_states // blocks <= plk2.CHIP_STATES * 8 <= 227 * 1024 - 8192
        assert pc.num_states // blocks // 4 >= 32


@pytest.mark.parametrize("want_g2", [False, True], ids=["words", "g2"])
@pytest.mark.parametrize("batch", [1, 3, 32, 64, 65, 128])
@pytest.mark.parametrize("K", [11, 12, 13, 14, 15, 16, 17])
def test_chip_depth(K, batch, want_g2):
    """Steps a cluster barrier of the on-chip kernel: four exactly where a
    frame spans a cluster (``chip_blocks >= 2``: K=14-15 up to 64 frames,
    K=16-17 at any batch), for words alone and a call of four steps or more;
    two in one block, with G_2 planes, or for fewer than four steps."""
    pc = ported(J.CodeSpec("k", K, 3, tuple((1 << (K - 1)) | (2 * r + 1) for r in range(3))),
                J.soft8_spec(3))[0]
    blocks = plk2.chip_blocks(pc, batch)
    spans = blocks >= 2
    assert spans == (K >= 16 or (K >= 14 and batch <= 64))
    for T in (2062, 4, 3, 1):
        want = 4 if spans and not want_g2 and T >= 4 else 2
        assert plk2.chip_depth(blocks, want_g2, T) == want


# -- on the card: each CUDA kernel against its plain version ---------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [
    pytest.param(J.VITERBI615, "soft8_spec", 3, 16, None, id="cassini_soft8"),
    pytest.param(J.VITERBI29, "ka9q_offset_binary_spec", 90, 16, None, id="k9_ob_renorm"),
    pytest.param(J.VITERBI29, "ka9q_offset_binary_spec", 90, 16, 92, id="k9_ob_renorm_last_pair"),
    pytest.param(K8, "soft16_spec", 100, 8, None, id="k8_odd"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("jc,spec,noise,n_bytes,steps", CARD_CASES)
def test_cuda_large2(cuda_device, jc, spec, noise, n_bytes, steps, time_major):
    """``steps``: cut the block to that many steps (92: 46 pairs, so the
    renormalisation follows the last pair and shifts the metrics as they
    leave the on-chip kernel).  One launch a call."""
    jn = getattr(J, spec)() if spec == "ka9q_offset_binary_spec" else getattr(J, spec)(jc.R)
    pc, pn = ported(jc, jn)
    sym, m0 = inputs(jc, jn, 5, n_bytes, noise, seed=11, lift=(2, 30))
    s, m = torch.from_numpy(sym[:, :steps]).contiguous().cuda(), torch.from_numpy(m0).cuda()
    n = launches("acs_update_large2")
    got = plk2.acs_update_large2(pc, pn, m, s, time_major=time_major)
    want = plk2.acs_update_large2_ref(pc, pn, m, s, time_major=time_major)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert launches("acs_update_large2") == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI615], ids=["k7", "cassini"])
def test_cuda_large(cuda_device, jc):
    jn = J.soft8_spec(jc.R)
    pc, pn = ported(jc, jn)
    sym, m0 = inputs(jc, jn, 3, 4, 3, seed=12, lift=(2, 30))
    s, m = torch.from_numpy(sym[:, :31]).cuda(), torch.from_numpy(m0).cuda()
    got = plk.acs_update_large(pc, pn, m, s.contiguous())
    want = plk.acs_update_large_ref(pc, pn, m, s)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def launches(name):
    """The launches of a counter, at either depth of the on-chip kernel."""
    return _build.LAUNCHES[name] + _build.LAUNCHES[name + "_quads"]


def cassini_card(spec, B, noise, seed):
    jn = getattr(J, spec)(6)
    pc, pn = ported(J.VITERBI615, jn)
    sym, m0 = inputs(J.VITERBI615, jn, B, 256, noise, seed=seed)
    return pc, pn, torch.from_numpy(m0).cuda(), torch.from_numpy(sym).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(1, 2062), (3, 2062), (64, 2062), (64, 1576), (3, 1577)],
                         ids=["b1", "b3", "b64", "b64_788_pairs", "b3_788_pairs_tail"])
def test_cuda_large2_cassini_on_chip(cuda_device, B, T):
    """Cassini soft8 on the on-chip form, one launch a call (four blocks a
    frame at B=1 and 3, two at B=64, so four steps a cluster barrier): whole
    frames (shifts after pairs 393 and 787) and the 788-pair block, whose
    second shift follows the last pair (with and without the odd tail)."""
    pc, pn, m, s = cassini_card("soft8_spec", B, 3, seed=B + T)
    s = s[:, :T].contiguous()
    assert plk2.chip_blocks(pc, B) == (4 if B <= 32 else 2)
    assert plk2.renorm_schedule(pc, pn, T)[1] == 394
    n = dict(_build.LAUNCHES)
    got = plk2.acs_update_large2(pc, pn, m, s)
    want = plk2.acs_update_large2_ref(pc, pn, m, s)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES["acs_update_large2_quads"] == n["acs_update_large2_quads"] + 1
    assert all(_build.LAUNCHES[k] == n[k] for k in n if k != "acs_update_large2_quads")
    if T == 1576:
        assert (got[0].amin(dim=1) == 0).all()


K16R3 = (0o147153, 0o126715, 0o151127)
K17R3 = (0o247153, 0o326715, 0o351127)


@pytest.mark.cuda
@pytest.mark.parametrize("polys,B,T,high,rn,near", [
    (J.VITERBI615.polys, 1, 2060, 3, 394, False), (J.VITERBI615.polys, 3, 2061, 3, 394, False),
    (J.VITERBI615.polys, 32, 2062, 3, 394, False), (J.VITERBI615.polys, 64, 2059, 3, 394, False),
    (J.VITERBI615.polys, 64, 2062, 3, 394, False), (J.VITERBI615.polys, 3, 1030, 20, 53, False),
    (J.VITERBI615.polys, 64, 23, 111, 3, False), (J.VITERBI615.polys, 3, 22, 146, 1, False),
    (J.VITERBI615.polys, 3, 10, 3, 0, True), (J.VITERBI615.polys, 64, 9, 3, 0, True),
    (K16R3, 64, 21, 3, 0, False), (K16R3, 8, 24, 3, 0, True), (K17R3, 3, 22, 3, 0, False),
    (J.VITERBI615.polys, 64, 20, 111, 3, False), (J.VITERBI615.polys, 3, 108, 20, 53, False),
    (J.VITERBI615.polys, 64, 7196, None, 1199, False)],
    ids=["cassini-b1-t0mod4", "cassini-b3-t1mod4", "cassini-b32-t2mod4", "cassini-b64-t3mod4",
         "cassini-b64-frame", "cassini-rn53", "cassini-b64-rn3", "cassini-rn1",
         "cassini-near-limit-even", "cassini-b64-near-limit-odd", "k16r3-b64", "k16r3-b8-near-limit",
         "k17r3", "cassini-b64-rn3-last-pass", "cassini-rn53-last-pass",
         "cassini-hard8-b64-last-pass"])
def test_cuda_chip_four_steps_a_barrier(cuda_device, polys, B, T, high, rn, near):
    """Where a frame spans a cluster the on-chip kernel runs four steps a
    cluster barrier: its words, metrics and offset equal the plain version
    bit for bit, and the call counts as ``acs_update_large2_quads``.
    Cassini at four blocks a frame (B <= 32) and two (B=64), T = 0-3 mod 4
    (a pair, the odd step, or both after the passes); soft inputs widened
    to +-``high``, stored as int16, so that they renormalise every ``rn``
    pairs (53: after the first pair of a pass, as after pair 52, and after
    the second, as after 105; 3; 1: after both); an event after the first
    pair of the last pass with no odd step after it (rn=3 at T=20, rn=53 at
    T=108, and hard8, ``high`` None, whose rn is 1199, at T=7196); entry
    metrics within 64 of the int32 limit (``near``); R=3 codes at K=16 (two
    and four blocks) and K=17, the largest trellis on chip."""
    K = max(p.bit_length() for p in polys)
    jn = J.hard8_spec(len(polys)) if high is None else dataclasses.replace(
        J.soft8_spec(len(polys)), name=f"soft{high}", soft_high=high, soft_low=-high,
        metric_dtype="int16" if high > 3 else "auto")
    pc, pn = ported(J.CodeSpec(f"k{K}r{len(polys)}", K, len(polys), polys), jn)
    assert plk2.chip_blocks(pc, B) >= 2 and plk2.chip_depth(plk2.chip_blocks(pc, B), False, T) == 4
    assert plk2.renorm_schedule(pc, pn, T)[1] == rn
    rng = np.random.default_rng(B * T + (high or 1))
    s = torch.from_numpy(rng.integers(jn.soft_low, jn.soft_high + 1,
                                      size=(B, T, pc.R)).astype(np.int32)).cuda()
    lo = 2**31 - 64 if near else 5
    m = torch.from_numpy(rng.integers(lo, lo + 60, size=(B, pc.num_states)).astype(np.int32)).cuda()
    n = dict(_build.LAUNCHES)
    got = plk2.acs_update_large2(pc, pn, m, s)
    assert _build.LAUNCHES["acs_update_large2_quads"] == n["acs_update_large2_quads"] + 1
    assert all(_build.LAUNCHES[k] == n[k] for k in n if k != "acs_update_large2_quads")
    want = plk2.acs_update_large2_ref(pc, pn, m, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,want_g2,ok", [(64, False, True), (64, True, False),
                                          (128, False, False)], ids=["two-blocks", "g2", "one-block"])
def test_cuda_chip_launcher_checks_depth(cuda_device, B, want_g2, ok):
    """The on-chip launcher takes four steps a cluster barrier only where
    ``chip_depth`` may give it: a frame over two blocks or more and no G_2
    planes (Cassini B=64 at two blocks a frame; B=128 at one)."""
    pc, pn = ported(J.VITERBI615, J.soft8_spec(6))
    T, blocks = 8, plk2.chip_blocks(pc, B)
    assert (plk2.chip_depth(blocks, want_g2, T) == 4) == ok
    s = torch.zeros((B, T, 6), dtype=torch.int32, device="cuda")
    m = torch.zeros((B, pc.num_states), dtype=torch.int32, device="cuda")
    words, strides = plk2.words_buffer(B, T, pc.decision_words, False, m.device)
    g2 = torch.zeros((B, T // 2, pc.decision_words), dtype=torch.int32, device="cuda")

    def call():
        plk2.launch_chip(pc, pn, m, s, words, torch.zeros_like(m[:, 0]), strides, 0, T, 0, blocks,
                         g2=g2 if want_g2 else None, g2_strides=(g2.stride(0), g2.stride(1)),
                         _depth=4)

    if ok:
        call()
        torch.cuda.synchronize()
    else:
        with pytest.raises(RuntimeError):
            call()


@pytest.mark.cuda
def test_cuda_large2_cassini_soft16_time_major(cuda_device):
    """soft16: int32 schedule with no renormalisation; time-major words."""
    pc, pn, m, s = cassini_card("soft16_spec", 16, 160, seed=5)
    got = plk2.acs_update_large2(pc, pn, m, s, time_major=True)
    want = plk2.acs_update_large2_ref(pc, pn, m, s, time_major=True)
    assert got[1].shape == (2062, 16, 512)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_large2_cassini_want_g2(cuda_device):
    """The G_2 planes of a whole Cassini frame from the on-chip form."""
    pc, pn, m, s = cassini_card("soft8_spec", 4, 3, seed=6)
    got = plk2.acs_update_large2(pc, pn, m, s, want_g2=True)
    want = plk2.acs_update_large2_ref(pc, pn, m, s, want_g2=True)
    assert got[2].shape == (4, 1031, 512)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("K,R,polys,on_chip", [
    (17, 3, (0o247153, 0o326715, 0o351127), True), (18, 3, (0o647153, 0o526715, 0o751127), False),
    (8, 4, "both", True), (8, 5, "both", False), (9, 6, "one", False), (10, 6, "both", True),
    (10, 7, "both", False), (11, 7, "one", True), (11, 8, "one", False)],
    ids=["k17_on_chip", "k18_streams", "k8r4", "k8r5", "k9r6_one_end", "k10r6", "k10r7",
         "k11r7_one_end", "k11r8_one_end"])
def test_cuda_large2_fit_edge(cuda_device, K, R, polys, on_chip):
    """The edges of the on-chip form, each held against the plain version
    with its odd tail and G_2 planes: R=3 codes at the largest K whose frame
    fits on chip (a cluster of four blocks) and at the next; small trellises
    of wide codes, on chip where a block has at least as many threads as a
    pair has table entries (2^(R+1)), streaming where it has fewer (random
    codes that tap both register ends, or not).  Streaming runs the pair
    launch loop, then the odd tail on the step kernel."""
    rng = np.random.default_rng(K * 10 + R)
    if isinstance(polys, str):
        top = 1 << (K - 1)
        polys = tuple(int(top * (polys == "both" or r > 0) | rng.integers(0, top) | 1)
                      for r in range(R))
    jc, jn = J.CodeSpec(f"k{K}r{R}", K, R, polys), J.ka9q_offset_binary_spec()
    pc, pn = ported(jc, jn)
    assert (plk2.chip_blocks(pc, 3) > 0) == on_chip
    s = torch.from_numpy(rng.integers(jn.soft_low, jn.soft_high + 1, size=(3, 21, R))
                         .astype(np.int32)).cuda()
    m = torch.from_numpy(rng.integers(5, 60, size=(3, pc.num_states)).astype(np.int32)).cuda()
    n = dict(_build.LAUNCHES)
    got = plk2.acs_update_large2(pc, pn, m, s, want_g2=True)
    want = plk2.acs_update_large2_ref(pc, pn, m, s, want_g2=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES["acs_update_large2"] == n["acs_update_large2"] + 1
    assert _build.LAUNCHES["acs_update_large"] == n["acs_update_large"] + (0 if on_chip else 1)


# Entry metrics within 64 of the int32 limit (so that a step's penalties
# carry most of them past it), their minimum far from zero:
# the plain version shifts them to zero first, as the JAX package does; a
# call whose first launch skipped that shift would wrap.  Both entry points
# in every form: on chip (Cassini), streaming (a K=10 R=7 code, whose blocks
# are too small for the on-chip form) and, for ``acs_update_large``, octets
# (a K=18 R=2 code, whose frame does not fit on chip; ``acs_update_large2``
# streams it), at odd and even lengths.
K10R7 = (0o1167, 0o1546, 0o1353, 0o1731, 0o1215, 0o1473, 0o1621)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["large2", "large"])
@pytest.mark.parametrize("K,polys,T", [
    (15, J.VITERBI615.polys, 9), (15, J.VITERBI615.polys, 10), (10, K10R7, 9), (10, K10R7, 10),
    (18, (0o647153, 0o526715), 9), (18, (0o647153, 0o526715), 10)],
    ids=["cassini-odd", "cassini-even", "k10r7-streaming-odd", "k10r7-streaming-even",
         "k18r2-odd", "k18r2-even"])
def test_cuda_entry_metrics_near_the_limit(cuda_device, fn, K, polys, T):
    pc = code_from_fields(f"k{K}r{len(polys)}", K, len(polys), polys)
    pn = numeric_from_fields(**dataclasses.asdict(J.soft8_spec(pc.R)))
    assert (plk2.chip_blocks(pc, 3) > 0) == (K == 15)
    if fn == "large":
        assert plk.plan(pc, 3, T).form == {15: "chip", 10: "stream", 18: "octets"}[K]
    rng = np.random.default_rng(K + T)
    s = torch.from_numpy(rng.integers(-3, 4, size=(3, T, pc.R)).astype(np.int32)).cuda()
    m = torch.from_numpy(rng.integers(2**31 - 64, 2**31 - 1, size=(3, pc.num_states))
                         .astype(np.int32)).cuda()
    mod, name = (plk2, "acs_update_large2") if fn == "large2" else (plk, "acs_update_large")
    got = getattr(mod, name)(pc, pn, m, s)
    want = getattr(mod, name + "_ref")(pc, pn, m, s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
