"""The port's multi-device paths against the JAX package's.

The port's sharded decodes run on an in-process ``Mesh`` on the CPU (every
shard's kernel takes its plain version); the JAX functions run on the
8-device CPU mesh of ``tests/conftest.py``.  Same seeded numpy symbols on
both sides: noiseless, noisy (uniform integer noise, clipped to the rails)
and "erasure" frames (a stretch of zero symbols in the middle, where the
warm-ups and end states meet ties).  Tolerance: none -- trellis bits and
bytes are compared for equality.  Also: ``pad_to_time_blocks``, the
end-state tie-break, the state axis's device-count check as the JAX module
writes it, and the mesh's collectives against ``jax.lax``'s on the same
shard values.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as JP

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu.parallel as JPar
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.parallel import state_time as j_state_time
from ka9q_viterbi_comparison_tpu.parallel import statewise as j_statewise
from ka9q_viterbi_comparison_tpu_torch import parallel as par
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, inplace
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.parallel import state_time, statewise
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors

KINDS = ("clean", "noisy", "erasure")


def _jcode(code):
    return {c.name: c for c in J.STANDARD_CODES}.get(code.name) or J.CodeSpec(
        code.name, code.K, code.R, code.polys)


def _jnum(numeric):
    return J.NumericSpec(**{f.name: getattr(numeric, f.name)
                            for f in dataclasses.fields(numeric)})


def _jit(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of the JAX package under one ``jax.jit``: the
    same integer program, compiled once instead of dispatched op by op
    (13 s a time-block call eagerly, 1 s so)."""
    return np.asarray(jax.jit(lambda s: fn(*args[:2], s, *args[3:], **kwargs))(args[2]))


def _jmesh(axes):
    names, sizes = tuple(axes), tuple(axes.values())
    n = int(np.prod(sizes))
    return JMesh(np.array(jax.devices()[:n]).reshape(sizes), names)


@functools.lru_cache(maxsize=None)
def _all_frames(code, n_bytes, kind, rows=64):
    numeric = P.soft8_spec(code.R)
    rng = np.random.default_rng([code.K, code.R, n_bytes, KINDS.index(kind)])
    data = rng.integers(0, 256, size=(rows, n_bytes), dtype=np.uint8)
    sym = encode_frames(code, numeric, torch.from_numpy(data)).numpy().reshape(rows, -1, code.R)
    if kind == "noisy":
        sym = sym + rng.integers(-2, 3, size=sym.shape)
    elif kind == "erasure":
        T = sym.shape[1]
        sym = sym.copy()
        sym[:, T // 3: 2 * T // 3] = (numeric.soft_high + numeric.soft_low) // 2
    return data, np.clip(sym, numeric.soft_low, numeric.soft_high).astype(np.int32)


def _frames(code, B, n_bytes, kind):
    """``(data [B, n_bytes], symbols [B, T, R] int32)`` as numpy: the first
    B of 64 seeded frames of this code, size and kind."""
    data, sym = _all_frames(code, n_bytes, kind)
    return data[:B], sym[:B]


def _kinds_stacked(code, B, n_bytes, kinds=KINDS):
    """Every kind's first B frames in one batch, so that one JAX call (one
    compile) serves all kinds: ``[len(kinds) * B, T, R]``."""
    return np.concatenate([_frames(code, B, n_bytes, k)[1] for k in kinds])


def _pad_erasure(code, sym, multiple):
    """Pad the time axis to ``multiple`` with erasure symbols, as
    ``tests/test_parallel.py`` does."""
    numeric = P.soft8_spec(code.R)
    pad = (-sym.shape[1]) % multiple
    mid = (numeric.soft_high + numeric.soft_low) // 2
    return np.pad(sym, ((0, 0), (0, pad), (0, 0)), constant_values=mid)


# -- frame DP ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_frame_dp():
    code, n_bytes, B = P.VITERBI27, 64, 16
    flat = _kinds_stacked(code, B, n_bytes, KINDS[:2]).reshape(2 * B, -1)
    return _jit(JPar.frame_sharded_decode, _jcode(code), _jnum(P.soft8_spec(2)),
                jnp.asarray(flat), n_bytes * 8, JPar.make_frame_mesh())


@pytest.mark.parametrize("kind", KINDS[:2])
def test_frame_dp_matches_jax(kind):
    code, n_bytes, B = P.VITERBI27, 64, 16
    numeric = P.soft8_spec(2)
    data, sym = _frames(code, B, n_bytes, kind)
    out = par.frame_sharded_decode(code, numeric, sym.reshape(B, -1), n_bytes * 8,
                                   par.make_frame_mesh(8, device="cpu"))
    k = KINDS.index(kind)
    np.testing.assert_array_equal(out.numpy(), _jax_frame_dp()[k * B:(k + 1) * B])
    if kind == "clean":
        assert count_bit_errors(out, data) == 0


# -- time blocks ------------------------------------------------------------------------

TB_MESHES = {"f2t4": {"frame": 2, "time": 4}, "t2": {"time": 2}}
# batch -> the folded batch (local shards x rows) is below or at 128: the
# state-order pair or the in-place pair on the CPU's plain versions.
TB_BATCHES = {("f2t4", "pair"): 4, ("f2t4", "inplace"): 32,
              ("t2", "pair"): 2, ("t2", "inplace"): 64}


TB_ROWS = max(TB_BATCHES.values())


@functools.lru_cache(maxsize=None)
def _jax_time_block(code, mesh_name):
    """JAX trellis bits of every kind's first ``TB_ROWS`` frames, one call:
    ``[len(KINDS) * TB_ROWS, T]``."""
    axes = TB_MESHES[mesh_name]
    sym = _pad_erasure(code, _kinds_stacked(code, TB_ROWS, 64), axes["time"])
    return _jit(JPar.time_block_decode_bits, _jcode(code), _jnum(P.soft8_spec(2)),
                jnp.asarray(sym), _jmesh(axes))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ["pair", "inplace"])
@pytest.mark.parametrize("mesh_name", list(TB_MESHES))
@pytest.mark.parametrize("code", [P.VITERBI27, P.VITERBI29], ids=["k7", "k9"])
def test_time_block_matches_jax(code, mesh_name, route, kind, monkeypatch):
    """Bits on both routes: the in-place pair walks position-packed words
    (``chainback_inplace`` at the call's ``t0 = 0``), the last block's halo
    words zeroed; the state-order pair walks canonical words."""
    B = TB_BATCHES[(mesh_name, route)]
    axes = TB_MESHES[mesh_name]
    mesh = par.Mesh(axes, "cpu")
    N = mesh.n_local * B // axes.get("frame", 1)
    assert dispatch.use_inplace(code, N, torch.device("cpu")) == (route == "inplace")
    walks = []
    real = inplace.chainback_inplace
    monkeypatch.setattr(inplace, "chainback_inplace",
                        lambda *a, **k: walks.append(a[-1] if len(a) > 4 else 0) or real(*a, **k))
    sym = _pad_erasure(code, _frames(code, B, 64, kind)[1], axes["time"])
    bits = par.time_block_decode_bits(code, P.soft8_spec(2), sym, mesh)
    k = KINDS.index(kind)
    np.testing.assert_array_equal(bits.numpy(), _jax_time_block(code, mesh_name)[
        k * TB_ROWS:k * TB_ROWS + B])
    assert walks == ([0] if route == "inplace" else [])
    if kind == "clean":
        data, _ = _frames(code, B, 64, kind)
        out = par.time_block_decode(code, P.soft8_spec(2), sym, 64 * 8, mesh)
        assert count_bit_errors(out, data) == 0


def test_time_block_above_k15_takes_the_large_k_plan():
    """K=16: the main ACS takes the large-K plan, whose metrics come back
    less their renormalisation offset; the end states and bits do not move,
    and the walk is the portable one."""
    code = P.CodeSpec("k16r2", 16, 2, (0o152711, 0o126723))
    numeric = P.soft8_spec(2)
    _, sym = _frames(code, 1, 4, "noisy")
    sym = _pad_erasure(code, sym, 2)
    mesh = par.Mesh({"time": 2}, "cpu")
    bits = par.time_block_decode_bits(code, numeric, sym, mesh, overlap=16)
    want = _jit(JPar.time_block_decode_bits, _jcode(code), _jnum(numeric), jnp.asarray(sym),
                _jmesh({"time": 2}), overlap=16)
    np.testing.assert_array_equal(bits.numpy(), want)


def test_argmin_takes_the_first_index():
    m = torch.tensor([[5, 2, 2, 7, 2], [1, 1, 1, 1, 1], [9, 8, 7, 7, 6]], dtype=torch.int32)
    np.testing.assert_array_equal(torch.argmin(m, dim=-1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(m.numpy()), axis=-1)))


@pytest.mark.parametrize("n_state", [2, 4, 8])
def test_global_best_breaks_ties_at_the_first_index(n_state):
    """The state x time end state over shards: the ``pmin`` of the shards'
    minima, then of the candidate indices, equals ``argmin`` of the whole
    vector, with the minimum tied within and across shards."""
    S, B = 64, 6
    rng = np.random.default_rng(n_state)
    m = rng.integers(3, 9, size=(B, S)).astype(np.int32)
    m[0, [5, 6, 40]] = 0           # within a shard first, then across
    m[1, [S - 1, S // 2]] = 0       # the later shard holds the lower index
    m[2] = 1                        # every state tied
    m[3, [S // n_state, 2 * S // n_state - 1]] = 0  # a shard's first and last
    mesh = par.Mesh({"state": n_state}, "cpu")
    n_local = S // n_state
    shards = mesh.shard(torch.from_numpy(m), (None, "state"))
    base = mesh.axis_index("state") * n_local
    best = state_time._global_best(mesh, shards, base, "state", S)
    for j in range(n_state):
        np.testing.assert_array_equal(best[j].numpy(), np.argmin(m, axis=-1))


# -- state sharding ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_state_sharded(code, n_bytes, n_dev):
    return _jit(JPar.state_sharded_decode_bits, _jcode(code), _jnum(P.soft8_spec(code.R)),
                jnp.asarray(_kinds_stacked(code, 2, n_bytes)), _jmesh({"state": n_dev}))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("code,n_bytes,n_dev", [(P.VITERBI29, 32, 2), (P.VITERBI29, 32, 4),
                                                (P.VITERBI29, 32, 8), (P.VITERBI615, 4, 4)],
                         ids=["viterbi29-2", "viterbi29-4", "viterbi29-8", "viterbi615-4"])
def test_state_sharded_matches_jax(code, n_bytes, n_dev, kind):
    numeric = P.soft8_spec(code.R)
    data, sym = _frames(code, 2, n_bytes, kind)
    bits = par.state_sharded_decode_bits(code, numeric, sym, par.Mesh({"state": n_dev}, "cpu"))
    k = KINDS.index(kind)
    np.testing.assert_array_equal(bits.numpy(),
                                  _jax_state_sharded(code, n_bytes, n_dev)[2 * k:2 * k + 2])
    if kind == "clean":
        out = par.state_sharded_decode(code, numeric, sym, n_bytes * 8,
                                       par.Mesh({"state": n_dev}, "cpu"))
        assert count_bit_errors(out, data) == 0


class _StubMesh:
    def __init__(self, n):
        self.shape = {"state": n}


@pytest.mark.parametrize("n_dev", [1, 2, 3, 5, 6, 7, 12, 64, 128, 256, 512])
def test_state_axis_check_is_the_jax_modules(n_dev):
    """``statewise.py:198`` reads ``A or B and C``; the port copies it.  The
    JAX function raises (or not) before it reads anything of the mesh but
    its shape, so a stub mesh shows its verdict for any axis size."""
    code = J.VITERBI29
    sym = jnp.zeros((1, 20, 2), jnp.int32)
    try:
        j_statewise.state_sharded_decode_bits(code, J.soft8_spec(2), sym, _StubMesh(n_dev))
        jax_raises = False
    except Exception as e:  # noqa: BLE001 - past the check, the stub fails in shard_map
        jax_raises = isinstance(e, ValueError) and "incompatible" in str(e)
    try:
        statewise._check_state_axis(code.num_states, n_dev)
        port_raises = False
    except ValueError:
        port_raises = True
    assert port_raises == jax_raises
    if port_raises:
        with pytest.raises(ValueError, match="incompatible"):
            par.state_sharded_decode_bits(P.VITERBI29, P.soft8_spec(2), torch.zeros(
                (1, 20, 2), dtype=torch.int32), par.Mesh({"state": n_dev}, "cpu"))


# -- state x time -----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_state_time(n_state, n_time):
    """JAX trellis bits of every kind's two VITERBI29 32-byte frames, padded
    to the time axis, in one call."""
    padded, _ = JPar.pad_to_time_blocks(_jcode(P.VITERBI29), _jnum(P.soft8_spec(2)),
                                        jnp.asarray(_kinds_stacked(P.VITERBI29, 2, 32)), n_time)
    return _jit(JPar.state_time_decode_bits, _jcode(P.VITERBI29), _jnum(P.soft8_spec(2)), padded,
                _jmesh({"state": n_state, "time": n_time}), overlap=32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_state,n_time", [(2, 2), (4, 2), (2, 4)])
def test_state_time_matches_jax(n_state, n_time, kind):
    code, n_bytes = P.VITERBI29, 32
    numeric = P.soft8_spec(2)
    data, sym = _frames(code, 2, n_bytes, kind)
    mesh = par.Mesh({"state": n_state, "time": n_time}, "cpu")
    padded, _ = par.pad_to_time_blocks(code, numeric, torch.from_numpy(sym), n_time)
    bits = par.state_time_decode_bits(code, numeric, padded, mesh, overlap=32)
    want = _jax_state_time(n_state, n_time)[2 * KINDS.index(kind):][:2]
    np.testing.assert_array_equal(bits.numpy(), want)
    out = par.state_time_decode(code, numeric, sym, n_bytes * 8, mesh, overlap=32)
    np.testing.assert_array_equal(
        out.numpy(), np.packbits(want[:, code.K - 1:code.K - 1 + n_bytes * 8], axis=1))
    if kind == "clean":
        assert count_bit_errors(out, data) == 0


@pytest.mark.parametrize("code", [P.VITERBI29, P.VITERBI224,
                                  P.CodeSpec("inv27", 7, 2, (-0o155, 0o117))],
                         ids=["viterbi29", "viterbi224", "inverted"])
@pytest.mark.parametrize("multiple", [1, 2, 16])
def test_pad_to_time_blocks_matches_jax(code, multiple):
    numeric = P.soft8_spec(code.R)
    sym = np.random.default_rng(3).integers(-3, 4, size=(2, 21, code.R)).astype(np.int32)
    padded, pad = par.pad_to_time_blocks(code, numeric, torch.from_numpy(sym), multiple)
    jpadded, jpad = j_state_time.pad_to_time_blocks(_jcode(code), _jnum(numeric),
                                                     jnp.asarray(sym), multiple)
    assert pad == jpad == (-21) % multiple
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))


# -- the mesh's collectives -------------------------------------------------------------


def _jax_collectives(x):
    """shard_map over a (a=2, b=4) mesh, one ``[3]`` value a device."""
    jmesh = _jmesh({"a": 2, "b": 4})
    perm = [(0, 1), (1, 3), (3, 2)]  # b=0 receives nothing

    @functools.partial(jax.shard_map, mesh=jmesh, in_specs=(JP("a", "b"),),
                       out_specs=(JP("a", "b"),) * 5)
    def body(v):
        return (jax.lax.ppermute(v, "b", perm), jax.lax.psum(v, "a"), jax.lax.psum(v, "b"),
                jax.lax.pmin(v, "b"), jax.lax.all_gather(v, "b", axis=1, tiled=True))

    return [np.asarray(o) for o in body(jnp.asarray(x))], perm


def test_mesh_collectives_match_jax():
    x = np.random.default_rng(5).integers(-50, 50, size=(2, 4, 3)).astype(np.int32)
    (pp, ps_a, ps_b, pm_b, ag_b), perm = _jax_collectives(x)
    mesh = par.Mesh({"a": 2, "b": 4}, "cpu")
    xs = torch.from_numpy(x.reshape(8, 3))

    def back(t):
        return t.numpy().reshape(2, 4, *t.shape[1:])

    np.testing.assert_array_equal(back(mesh.ppermute(xs, "b", perm)), pp)
    assert not back(mesh.ppermute(xs, "b", perm))[:, 0].any()  # zero-fill
    np.testing.assert_array_equal(back(mesh.psum(xs, "a")), ps_a)
    np.testing.assert_array_equal(back(mesh.psum(xs, "b")), ps_b)
    np.testing.assert_array_equal(back(mesh.pmin(xs, "b")), pm_b)
    gathered = back(mesh.all_gather(xs, "b"))  # [2, 4, n_b=4, 3]
    np.testing.assert_array_equal(gathered.transpose(0, 1, 2, 3).reshape(2, 16, 3), ag_b)
    np.testing.assert_array_equal(mesh.axis_index("b").numpy(), [0, 1, 2, 3, 0, 1, 2, 3])


def test_mesh_shard_round_trip_and_refusals():
    mesh = par.Mesh({"frame": 2, "time": 4}, "cpu")
    x = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    s = mesh.shard(x, ("frame", "time"))
    assert s.shape == (8, 2, 2, 3)
    torch.testing.assert_close(mesh.unshard(s, ("frame", "time")), x)
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard(torch.zeros(3, 8), ("frame", "time"))
    with pytest.raises(ValueError, match="not a permutation"):
        mesh.ppermute(s, "time", [(0, 1), (2, 1)])
    with pytest.raises(ValueError, match="not divisible"):
        par.time_block_decode_bits(P.VITERBI27, P.soft8_spec(2),
                                   torch.zeros((2, 518, 2), dtype=torch.int32), mesh)


def test_parallel_exports_mirror_jax_package():
    assert set(JPar.__all__) <= set(par.__all__)
    for name in par.__all__:
        assert hasattr(par, name)
