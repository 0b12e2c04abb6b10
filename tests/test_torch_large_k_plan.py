"""The launch plan of ``large_k.acs_update_large`` (``large_k.plan``).

On the CPU: the form (on chip, octets, streaming) and the launches a call
that ``plan`` picks, across the codes at the edges of each form (Cassini at
three batches, K=8 and K=17 on chip against the shapes beside them that
stream, ICE and a K=18 r=1/2 code on octets, a K=10 R=7 code and K=7
streaming) and every ``T % 8``; the plan's segments run on the plain ACS
with the entry shift only (``plan_ref``) bit-identical to
``acs_update_large_ref`` in each form, and at one shape of
``test_torch_large_k.py::test_matches_jax`` also to the JAX package's
``acs_update_large`` in interpret mode.  Tests marked ``cuda`` hold each
form on the card against the plain version and count the launcher calls of
a call; they skip where there is no card.  Tolerance: exact equality
(integer arithmetic)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs
from ka9q_viterbi_comparison_tpu.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu.ops.pallas import large_k as jlk
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, large_k as plk, large_k2 as plk2

CODES = {
    "cassini": J.VITERBI615,
    "ice": J.VITERBI224,
    "k7": J.VITERBI27,
    "k8r4": J.CodeSpec("k8r4", 8, 4, (0o357, 0o251, 0o311, 0o235)),
    "k8r5": J.CodeSpec("k8r5", 8, 5, (0o357, 0o251, 0o311, 0o235, 0o323)),
    "k10r7": J.CodeSpec("k10r7", 10, 7, (0o1167, 0o1546, 0o1353, 0o1731, 0o1215, 0o1473, 0o1621)),
    "k17r3": J.CodeSpec("k17r3", 17, 3, (0o247153, 0o326715, 0o351127)),
    "k18r3": J.CodeSpec("k18r3", 18, 3, (0o647153, 0o526715, 0o751127)),
    "k18r2": J.CodeSpec("k18r2", 18, 2, (0o647153, 0o526715)),
}
# Launches a call of the octet form by T (the entry minimum's included):
# octets, a lone quad for an odd number of quads, the last quad and a 3-step
# remainder as one 7-step launch, a 1- or 2-step remainder as one step or
# pair launch.
OCTET_LAUNCHES = {1: 2, 2: 2, 3: 2, 4: 2, 5: 3, 6: 3, 7: 2, 8: 2, 9: 3, 10: 3, 11: 3, 12: 3,
                  13: 4, 14: 4, 15: 3, 16: 3, 87: 12}


def ported(jc, jn=None):
    jn = jn or J.soft8_spec(jc.R)
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def random_inputs(pc, pn, B, T, seed):
    """Symbols across the soft range and metrics lifted by 3-40 (a non-zero
    entry shift)."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(pn.soft_low, pn.soft_high + 1, size=(B, T, pc.R)).astype(np.int32)
    m = rng.integers(3, 40, size=(B, pc.num_states)).astype(np.int32)
    return torch.from_numpy(m), torch.from_numpy(sym)


@pytest.mark.parametrize("name,B,form,blocks", [
    ("cassini", 8, "chip", 4), ("cassini", 64, "chip", 2), ("cassini", 128, "chip", 1),
    ("k8r4", 8, "chip", 1), ("k8r5", 8, "stream", 0), ("k17r3", 8, "chip", 4),
    ("k18r3", 8, "stream", 0), ("ice", 8, "octets", 0), ("k18r2", 2, "octets", 0),
    ("k10r7", 8, "stream", 0), ("k7", 64, "stream", 0)])
def test_plan_form_and_launches(name, B, form, blocks):
    """One launch a call on chip, whatever T (T = 1 included); the octet form
    by ``OCTET_LAUNCHES``; streaming a pair a launch and the odd step (K=7:
    a step a launch), each after the entry minimum.  The segments tile the
    call in step order."""
    pc = ported(CODES[name])[0]
    for T in list(range(1, 17)) + [87, 1031]:
        p = plk.plan(pc, B, T)
        assert (p.form, p.blocks) == (form, blocks), T
        t = 0
        for kind, t0, n in p.segments:
            assert t0 == t and n >= 1
            t += n
        assert t == T
        if form == "chip":
            assert p.launches == 1 and p.segments == (("chip", 0, T),)
        elif form == "octets":
            if T in OCTET_LAUNCHES:
                assert p.launches == OCTET_LAUNCHES[T], T
            assert {k for k, _, _ in p.segments} <= {"quads", "pairs", "steps"}
            assert p.segments[0][0] == ("quads" if T >= 3 else "pairs" if T == 2 else "steps")
        elif pc.K == 7:
            assert p.launches == T + 1 and p.segments == (("steps", 0, T),)
        else:
            assert p.launches == 1 + T // 2 + T % 2
            assert [k for k, _, _ in p.segments] == ["pairs"] * (T >= 2) + ["steps"] * (T % 2)


def test_plan_raises_where_no_form_takes_the_shape():
    pc = ported(J.VITERBI615)[0]
    for code, B, T in ((ported(J.CodeSpec("k6", 6, 2, (0o53, 0o75)))[0], 1, 4), (pc, 1, 0),
                       (pc, 65536, 4)):
        with pytest.raises(ValueError, match="no form takes"):
            plk.plan(code, B, T)


def test_plan_caps_the_batch_at_65535():
    """A call takes at most 65535 frames (``MAX_CALL_B``, the kernels' grid y
    extent), a recorded difference from the JAX package, which has none."""
    pc = ported(J.VITERBI615)[0]
    assert plk.MAX_CALL_B == 65535
    assert plk.plan(pc, 65535, 4).launches >= 1
    with pytest.raises(ValueError, match="at most 65535 frames a call"):
        plk.plan(pc, 65536, 4)


@pytest.mark.parametrize("name,B,Ts", [
    ("cassini", 2, (1, 2, 9, 16)), ("k8r5", 3, (1, 2, 7, 8)), ("k17r3", 1, (3, 4)),
    ("k18r2", 2, tuple(range(1, 17))), ("k18r3", 1, (1, 4, 5)), ("k10r7", 3, (1, 2, 9, 16)),
    ("k7", 3, (1, 5, 8))])
def test_plan_segments_match_the_plain_version(name, B, Ts):
    """Each form's segments on the plain ACS, with the entry shift only,
    equal the plain version: metrics, words and offset (the octet form at
    every ``T % 8`` and with remainders of 1-3 steps)."""
    pc, pn = ported(CODES[name])
    for T in Ts:
        m, sym = random_inputs(pc, pn, B, T, seed=pc.K * 100 + T)
        got = plk.plan_ref(pc, pn, m, sym)
        want = plk.acs_update_large_ref(pc, pn, m, sym)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (name, T)
        assert (got[2] >= 3).all()


def test_plan_ref_matches_jax():
    """The K=8 shape of ``test_torch_large_k.py::test_matches_jax`` (71 steps,
    on chip): the plan's segments on the plain ACS against the JAX package's
    ``acs_update_large`` in interpret mode."""
    jc = J.CodeSpec("k8r2", 8, 2, (0o357, 0o251))
    jn = J.soft8_spec(2)
    rng = np.random.default_rng(jc.K)
    data = rng.integers(0, 256, size=(2, 8), dtype=np.uint8)
    sym = np.asarray(encode_frames(jc, jn, jnp.asarray(data))).reshape(2, -1, jc.R)
    sym = np.clip(sym + rng.integers(-4, 5, size=sym.shape), jn.soft_low, jn.soft_high)
    m0 = np.asarray(jacs.init_metrics(jc, jn, 2)) + rng.integers(3, 40, size=(2, jc.num_states))
    sym, m0 = sym.astype(np.int32), m0.astype(np.int32)
    pc, pn = ported(jc, jn)
    assert plk.plan(pc, 2, sym.shape[1]).form == "chip"
    jm, jw, joff = jlk.acs_update_large(jc, jn, jnp.asarray(m0), jnp.asarray(sym), True)
    m, w, off = plk.plan_ref(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(w.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))


# -- on the card: each form against the plain version ------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,T,form", [
    ("cassini", 3, 9, "chip"), ("cassini", 3, 10, "chip"), ("cassini", 64, 1031, "chip"),
    ("cassini", 64, 1, "chip"), ("k8r4", 3, 21, "chip"), ("k8r5", 3, 21, "stream"),
    ("k17r3", 3, 21, "chip"), ("k18r3", 2, 9, "stream"), ("ice", 2, 7, "octets"),
    ("ice", 2, 9, "octets"), ("ice", 2, 1, "octets"), ("k18r2", 3, 87, "octets"),
    ("k10r7", 3, 21, "stream"), ("k7", 3, 20, "stream")])
def test_cuda_forms(cuda_device, name, B, T, form):
    """``acs_update_large`` on the card equals its plain version in each
    form, with one launcher call a segment of its plan (the on-chip form:
    one launch a call) counted as ``acs_update_large`` and no other."""
    pc, pn = ported(CODES[name])
    m, sym = random_inputs(pc, pn, B, T, seed=pc.K + T)
    m, sym = m.cuda(), sym.cuda()
    p = plk.plan(pc, B, T)
    assert p.form == form
    n = dict(_build.LAUNCHES)
    got = plk.acs_update_large(pc, pn, m, sym)
    after = dict(_build.LAUNCHES)
    want = plk.acs_update_large_ref(pc, pn, m, sym)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert after["acs_update_large"] == n["acs_update_large"] + len(p.segments)
    assert all(after[k] == n[k] for k in n if k != "acs_update_large")


@pytest.mark.cuda
def test_cuda_ice_remainder_takes_the_quads_minimum(cuda_device):
    """``acs_update_large4`` at ICE with 1- and 2-step remainders (the decoder's
    blocks of 41 and 46 steps): the last quad launch leaves the remainder's
    entry shift, and the result equals the plain version."""
    from ka9q_viterbi_comparison_tpu_torch.ops.cuda import large_k4 as plk4
    pc, pn = ported(J.VITERBI224)
    for T in (41, 46, 5, 6):
        m, sym = random_inputs(pc, pn, 2, T, seed=T)
        m, sym = m.cuda(), sym.cuda()
        got = plk4.acs_update_large4(pc, pn, m, sym)
        want = plk4.acs_update_large4_ref(pc, pn, m, sym)
        for g, w in zip(got, want):
            assert torch.equal(g, w), T
        assert plk2.chip_blocks(pc, 2) == 0
