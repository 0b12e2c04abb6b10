"""The depth-4 large-K kernel family of the port's third slice.

On the CPU, the plain versions (``acs_update_large4_ref``,
``acs_update_large4_fields_ref``, ``acs_update_large4_fields8_ref`` and
``acs_update_large2_ref`` with ``want_g2``, which the wrappers run for CPU
tensors) are held against the JAX package's ``large_k4`` and ``large_k2``
functions in interpret mode: metrics, offset and words or walk table
bit-equal, on numpy-made symbols.  (The fields forms on whole frames, with
the leads the dispatch gives them, are in ``test_torch_radix_planes.py``
beside ``build_plane_tables``, which they must agree with.)  Tests marked
``cuda`` hold the CUDA kernel against its plain version and skip where there
is no card.
Tolerance: exact equality (integer arithmetic)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import ka9q_viterbi_comparison_tpu as J
from ka9q_viterbi_comparison_tpu.ops import acs as jacs, radix_planes as jrp
from ka9q_viterbi_comparison_tpu.ops.pallas import large_k2 as jlk2, large_k4 as jlk4
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields, numeric_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops import radix_planes as prp
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, large_k2 as plk2, large_k4 as plk4

K10 = J.CodeSpec("k10test", K=10, R=2, polys=(0o1234, 0o1571))
K11 = J.CodeSpec("k11test", K=11, R=2, polys=(0o2672, 0o3545))
K12 = J.CodeSpec("k12r2", 12, 2, (0o6731, 0o5247))
K13R1 = J.CodeSpec("k13r1", 13, 1, (0o16731,))  # card cases: the R=1 build of the kernel


def ported(jc, jn):
    return (code_from_fields(jc.name, jc.K, jc.R, jc.polys),
            numeric_from_fields(**dataclasses.asdict(jn)))


def inputs(jc, jn, B, T, seed, lift=(0, 1)):
    """Random symbols over the whole alphabet ``[B, T, R]`` and metrics
    ``[B, S]``: the reset metrics plus a per-state lift in ``[lift[0],
    lift[1])``, so the entry shift is ``>= lift[0]``."""
    rng = np.random.default_rng(seed)
    sym = rng.integers(jn.soft_low, jn.soft_high + 1, size=(B, T, jc.R))
    m0 = np.asarray(jacs.init_metrics(jc, jn, B)) + rng.integers(*lift, size=(B, jc.num_states))
    return sym.astype(np.int32), m0.astype(np.int32)


def assert_same(got, want):
    """``(metrics, words or table, offset)`` of the port and of the JAX package."""
    m, w, off = got
    jm, jw, joff = want
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert w.shape == jw.shape
    np.testing.assert_array_equal(w.numpy().view(np.uint32), np.asarray(jw))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))


@pytest.mark.parametrize("T,time_major", [(16, False), (17, False), (18, False), (19, False),
                                          (19, True)])
def test_large4_matches_jax(T, time_major):
    """K=12 r=1/2, every remainder 0..3 (the remainder runs as an
    ``acs_update_large2`` block with its own entry shift and odd tail), from
    lifted metrics; time-major words at the longest."""
    jn = J.soft8_spec(2)
    pc, pn = ported(K12, jn)
    sym, m0 = inputs(K12, jn, 2, T, seed=T, lift=(3, 40))
    want = jlk4.acs_update_large4(K12, jn, jnp.asarray(m0), jnp.asarray(sym), True, None,
                                  time_major)
    got = plk4.acs_update_large4(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym),
                                 time_major=time_major)
    assert (got[2] >= 3).all()
    assert got[1].shape == ((T, 2, 64) if time_major else (2, T, 64))
    assert_same(got, want)


CADENCE = [
    # form, spec, T, lead, (rn quads or pairs), shift after the last launch
    pytest.param("words", "ka9q_offset_binary_spec", 92, 0, 11, False, id="words_ob"),
    pytest.param("words", "ka9q_offset_binary_spec", 91, 0, 11, True, id="words_ob_last_quad_rem3"),
]


@pytest.mark.parametrize("form,spec,T,lead,rn,last", CADENCE)
def test_inscan_renorm_cadences(form, spec, T, lead, rn, last):
    """Blocks whose worst case overflows int16, so the quad scan
    renormalises every ``rn`` quads, counted within the call.  ``last``: a
    shift follows the last quad.  (The fields forms' cadences, in quads and
    in quad pairs, fire in ``test_torch_radix_planes.py``.)"""
    jc = K11
    jn = getattr(J, spec)() if spec == "ka9q_offset_binary_spec" else getattr(J, spec)(jc.R)
    pc, pn = ported(jc, jn)
    steps = 8 if form == "fields8" else 4
    assert plk4.renorm_schedule4(pc, pn, T, None, steps) == (torch.int16, rn)
    units = (T - lead) // steps
    assert units >= rn and (units % rn == 0) == last
    sym, m0 = inputs(jc, jn, 2, T, seed=T, lift=(0, 50))
    jm, js = jnp.asarray(m0), jnp.asarray(sym)
    pm, ps = torch.from_numpy(m0), torch.from_numpy(sym)
    if form == "words":
        want = jlk4.acs_update_large4(jc, jn, jm, js, True)
        got = plk4.acs_update_large4(pc, pn, pm, ps)
    elif form == "fields":
        want = jlk4.acs_update_large4_fields(jc, jn, jm, js, lead, True)
        got = plk4.acs_update_large4_fields(pc, pn, pm, ps, lead)
    else:
        want = jlk4.acs_update_large4_fields8(jc, jn, jm, js, lead, True)
        got = plk4.acs_update_large4_fields8(pc, pn, pm, ps, lead)
    assert (got[2] > 0).all()
    assert_same(got, want)
    if last and not (form == "words" and T % 4):
        assert (got[0].amin(dim=1) == 0).all()


@pytest.mark.parametrize("spec,quads,pairs", [
    ("soft8_spec", 0, 0), ("hard8_spec", 0, 0), ("soft16_spec", 7, 3),
    ("ka9q_offset_binary_spec", 7, 3)])
def test_ice_schedules(spec, quads, pairs):
    """The reference's ICE frame (T = 87): soft8 and hard8 never
    renormalise; soft16 and offset-binary every 7 quads (21 quads: the third
    shift follows the last quad) and every 3 quad pairs."""
    pn = (getattr(J, spec)() if spec == "ka9q_offset_binary_spec" else getattr(J, spec)(2))
    pc, pn = ported(J.VITERBI224, pn)
    assert plk4.renorm_schedule4(pc, pn, 87)[1] == quads
    assert plk4.renorm_schedule4(pc, pn, 87, None, 8)[1] == pairs


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _walk(inner)


def jax_schedule4(jc, jn, T, metric_dtype, steps):
    """The storage type and ``rn`` the JAX depth-4 functions trace to (no
    lead, no remainder, so theirs is the only scan over the metric carry):
    the dtype of that carry, and ``rn - 1`` as the literal its in-scan
    ``cond`` predicate compares with (no ``cond``: rn = 0)."""
    fn = jlk4.acs_update_large4 if steps == 4 else jlk4.acs_update_large4_fields8
    extra = (True, metric_dtype) if steps == 4 else (0, True, metric_dtype)
    sds = jax.ShapeDtypeStruct
    jp = jax.make_jaxpr(lambda m, y: fn.__wrapped__(jc, jn, m, y, *extra))(
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


@pytest.mark.parametrize("steps", [4, 8], ids=["quads", "quad_pairs"])
def test_renorm_schedule4_matches_jax(steps):
    """Every numeric spec at K=11, at the ICE frame's length and at a long
    stream block with int16 storage forced."""
    jc = K11
    for spec in ("ka9q_offset_binary_spec", "soft16_spec", "soft8_spec", "hard8_spec"):
        jn = getattr(J, spec)() if spec == "ka9q_offset_binary_spec" else getattr(J, spec)(jc.R)
        pc, pn = ported(jc, jn)
        for T, metric_dtype in ((88, None), (40000, "int16")):
            try:
                want = jax_schedule4(jc, jn, T, metric_dtype, steps)
            except ValueError:
                with pytest.raises(ValueError, match="int16 metrics cannot hold"):
                    plk4.renorm_schedule4(pc, pn, T, metric_dtype, steps)
                continue
            assert plk4.renorm_schedule4(pc, pn, T, metric_dtype, steps) == want, (spec, T)


def test_refusals():
    """R > 2, fewer than 512 states, and a span that is no whole number of
    quads or quad pairs."""
    pc6, pn6 = ported(J.VITERBI615, J.soft8_spec(6))
    m = torch.zeros((1, pc6.num_states), dtype=torch.int32)
    with pytest.raises(ValueError, match="R <= 2"):
        plk4.acs_update_large4(pc6, pn6, m, torch.zeros((1, 4, 6), dtype=torch.int32))
    pc9, pn9 = ported(J.VITERBI29, J.soft8_spec(2))
    with pytest.raises(ValueError, match="K=9 < 10"):
        plk4.acs_update_large4(pc9, pn9, torch.zeros((1, 256), dtype=torch.int32),
                               torch.zeros((1, 4, 2), dtype=torch.int32))
    assert not plk4.supports(pc6) and not plk4.supports(pc9)
    pc, pn = ported(K10, J.soft8_spec(2))
    assert plk4.supports(pc)
    m, s = torch.zeros((1, 512), dtype=torch.int32), torch.zeros((1, 13, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        plk4.acs_update_large4_fields(pc, pn, m, s, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        plk4.acs_update_large4_fields8(pc, pn, m, s, 1)
    # An empty table when every step is a lead step.
    got = plk4.acs_update_large4_fields(pc, pn, m + 5, s[:, :2], 2)
    assert got[1].shape == (0, 4, 1, 16) and (got[2] >= 5).all() and got[0].amin() == 0


@pytest.mark.parametrize("time_major", [False, True], ids=["batch_major", "time_major"])
def test_want_g2_matches_jax(time_major):
    """The pair kernel's G_2 planes: equal to the JAX kernel's, and to the
    v=1 combine of ``build_plane_tables`` over the returned words in both
    packages; the other outputs do not change."""
    jc, jn = K11, J.soft8_spec(2)
    pc, pn = ported(jc, jn)
    sym, m0 = inputs(jc, jn, 2, 21, seed=7)  # odd: the tail has no plane
    jm, jw, jg2, joff = jlk2.acs_update_large2(jc, jn, jnp.asarray(m0), jnp.asarray(sym), True,
                                               None, True, time_major)
    m, w, g2, off = plk2.acs_update_large2(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym),
                                           time_major=time_major, want_g2=True)
    assert g2.shape == ((10, 2, 32) if time_major else (2, 10, 32))
    assert_same((m, w, off), (jm, jw, joff))
    np.testing.assert_array_equal(g2.numpy().view(np.uint32), np.asarray(jg2))
    plain = plk2.acs_update_large2(pc, pn, torch.from_numpy(m0), torch.from_numpy(sym),
                                   time_major=time_major)
    assert all(torch.equal(a, b) for a, b in zip(plain, (m, w, off)))
    w_tm = w if time_major else w.transpose(0, 1)
    g2_tm = g2 if time_major else g2.transpose(0, 1)
    assert torch.equal(prp.build_plane_tables(pc, w_tm, 0)["g2"], g2_tm)
    jtabs = jrp.build_plane_tables(jc, jnp.asarray(w_tm.numpy().view(np.uint32)), 0)
    np.testing.assert_array_equal(g2_tm.numpy().view(np.uint32), np.asarray(jtabs["g2"]))


# -- on the card: the CUDA kernel against its plain version ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_CODES = [pytest.param(K10, "soft8_spec", id="k10_soft8"),
              pytest.param(K12, "ka9q_offset_binary_spec", id="k12_ob_renorm"),
              pytest.param(K13R1, "soft16_spec", id="k13_rate1_soft16")]


def card_inputs(jc, spec, B, T, seed):
    jn = getattr(J, spec)() if spec == "ka9q_offset_binary_spec" else getattr(J, spec)(jc.R)
    pc, pn = ported(jc, jn)
    sym, m0 = inputs(jc, jn, B, T, seed, lift=(2, 30))
    return pc, pn, torch.from_numpy(m0).cuda(), torch.from_numpy(sym).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("T", [88, 89, 90, 91])
@pytest.mark.parametrize("jc,spec", CARD_CODES)
def test_cuda_large4(cuda_device, jc, spec, T, time_major):
    pc, pn, m, s = card_inputs(jc, spec, 5, T, seed=T)
    n = _build.LAUNCHES["acs_update_large4"]
    got = plk4.acs_update_large4(pc, pn, m, s, time_major=time_major)
    want = plk4.acs_update_large4_ref(pc, pn, m, s, time_major=time_major)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES["acs_update_large4"] == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fields", "fields8"])
@pytest.mark.parametrize("jc,spec", CARD_CODES)
def test_cuda_fields(cuda_device, jc, spec, form):
    lead = 3
    pc, pn, m, s = card_inputs(jc, spec, 5, lead + 88, seed=jc.K)
    fn = getattr(plk4, f"acs_update_large4_{form}")
    ref = getattr(plk4, f"acs_update_large4_{form}_ref")
    n = _build.LAUNCHES[f"acs_update_large4_{form}"]
    got, want = fn(pc, pn, m, s, lead), ref(pc, pn, m, s, lead)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES[f"acs_update_large4_{form}"] == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("jc,spec", CARD_CODES + [pytest.param(J.VITERBI615, "soft8_spec",
                                                               id="cassini")])
def test_cuda_want_g2(cuda_device, jc, spec, time_major):
    pc, pn, m, s = card_inputs(jc, spec, 3, 21, seed=2)
    got = plk2.acs_update_large2(pc, pn, m, s, time_major=time_major, want_g2=True)
    want = plk2.acs_update_large2_ref(pc, pn, m, s, time_major=time_major, want_g2=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


ICE_FORMS = {"words": ("acs_update_large4", ()), "fields": ("acs_update_large4_fields", (3,)),
             "fields8": ("acs_update_large4_fields8", (7,))}


def ice_card(spec, B, T, seed):
    return card_inputs(J.VITERBI224, spec, B, T, seed)


def held(name, pc, pn, m, s, extra=()):
    """One call of the kernel form ``name`` against its plain version, and
    the launch it counted."""
    n = _build.LAUNCHES[name]
    got = getattr(plk4, name)(pc, pn, m, s, *extra)
    want = getattr(plk4, name + "_ref")(pc, pn, m, s, *extra)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _build.LAUNCHES[name] == n + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(ICE_FORMS))
def test_cuda_ice_soft16_octets(cuda_device, form):
    """ICE soft16 B=2 T=87 in each form: renormalisation every 7 quads, so
    the shift after quad 6 falls between the two halves of the octet of
    quads 6-7 (taken at the transpose), and the one after quad 20 follows
    the lone quad; the f8 form every 3 octets, its last after the last."""
    name, lead = ICE_FORMS[form]
    pc, pn, m, s = ice_card("soft16_spec", 2, 87, seed=3)
    assert plk4.renorm_schedule4(pc, pn, 87)[1] == 7
    assert plk4.renorm_schedule4(pc, pn, 87, None, 8)[1] == 3
    got = held(name, pc, pn, m, s, lead)
    assert (got[2] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("T", [83, 84, 85, 86, 87])
def test_cuda_ice_remainders(cuda_device, T):
    """ICE soft8 B=1, words: 20 quads (ten octets) and the remainder 3, or
    21 quads (ten octets and a lone quad) and the remainders 0-3."""
    pc, pn, m, s = ice_card("soft8_spec", 1, T, seed=T)
    held("acs_update_large4", pc, pn, m, s)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(ICE_FORMS))
@pytest.mark.parametrize("jc,spec,B,T,leads", [
    pytest.param(K12, "soft8_spec", 64, 91, (3, 3), id="k12_b64"),
    pytest.param(K13R1, "soft8_spec", 16, 100, (0, 4), id="k13_rate1_b16")])
def test_cuda_small_k_octets(cuda_device, form, jc, spec, B, T, leads):
    """K=12 (eight octets, one block a frame) and K=13 at R=1 (sixteen) at the sizes the
    card smoke test holds them: each form against its plain version."""
    name = ICE_FORMS[form][0]
    pc, pn, m, s = card_inputs(jc, spec, B, T, seed=jc.K)
    held(name, pc, pn, m, s, () if form == "words" else (leads[form == "fields8"],))


# Entry metrics within 64 of the int32 limit (so that a step's penalties
# carry most of them past it), their minimum far from zero:
# the plain versions shift them to zero first, as the JAX package does; a
# call whose first launch skipped that shift would wrap.  Every route of the
# depth-4 forms' launch plans: a 7-step launch (T % 4 == 3), quads then a
# remainder block, the fields forms' one-launch lead (3 or 7 steps) and a
# lead of quads and pairs.
NEAR_LIMIT = [(plk4.acs_update_large4, 11, None), (plk4.acs_update_large4, 13, None),
              (plk4.acs_update_large4, 16, None), (plk4.acs_update_large4_fields, 11, 3),
              (plk4.acs_update_large4_fields, 13, 5), (plk4.acs_update_large4_fields8, 15, 7),
              (plk4.acs_update_large4_fields8, 13, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("fn,T,lead", NEAR_LIMIT,
                         ids=[f"{f.__name__}-T{T}-lead{lead}" for f, T, lead in NEAR_LIMIT])
def test_cuda_entry_metrics_near_the_limit(cuda_device, fn, T, lead):
    pc, pn, _, s = card_inputs(K12, "soft8_spec", 4, T, seed=T)
    rng = np.random.default_rng(T)
    m = torch.from_numpy(rng.integers(2**31 - 64, 2**31 - 1, size=(4, pc.num_states))
                         .astype(np.int32)).cuda()
    extra = () if lead is None else (lead,)
    got = fn(pc, pn, m, s, *extra)
    want = getattr(plk4, fn.__name__ + "_ref")(pc, pn, m, s, *extra)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
