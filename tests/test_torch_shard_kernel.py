"""The state-sharded trellis step's kernel: its step replayed, its route, its exchange.

``sharded_acs_step_kernel`` (``csrc/viterbi_shard.cu``, wrapper
``ops/cuda/shard.py``) runs one step of ``parallel/statewise.py``
``_sharded_acs_scan`` on a CUDA device: a thread a predecessor pair ``s2``,
the penalty index ``sum_r parity(s2 & (|poly_r| >> 1)) << r`` of the global
``s2`` xor the four constants ``c(h, bit)``, ties to the low predecessor,
int32 adds wrapping, and a warp's 64 decisions as two interleaved 32-lane
ballots.  Its operands come from ``Mesh.ppermute_sources``: each target's
low and high halves where they lie in this process, or the buffer that the
cross-process transfer filled.

Here the kernel's step is replayed in plain torch in that index arithmetic
(popcounts, the offsets, the ballots and their interleave) and held to the
plain scan ``_sharded_acs_scan_ref`` step by step and over whole scans, with
and without words, from entry metrics within 600 of the int32 limit, at K=9
on state 2, 4 and 8, K=9 with an inverted polynomial, K=15 and K=17 on state
4, and on a (state, time) mesh; ``ppermute_sources`` is held to the plain
exchange's chunks and recorded calls; the card's route is pinned on CPU
tensors (the route predicate as on a card, the launcher replaced by the
replay): one launch a step, bits equal to the JAX package's at the shapes of
``test_torch_parallel.py``, the collectives equal to the models, in one
process and in two gloo processes whose shards read some chunks in place and
receive the others.  Cases marked ``cuda`` hold the kernel to the plain scan
on the card.  Tolerance: exact equality (integer arithmetic).
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu_torch import parallel as par
from ka9q_viterbi_comparison_tpu_torch.harness import comms
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, shard
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.parallel import mesh as mesh_mod
from ka9q_viterbi_comparison_tpu_torch.parallel import statewise
from ka9q_viterbi_comparison_tpu_torch.utils.bits import wrap_int32

ROOT = pathlib.Path(__file__).resolve().parents[1]
K17 = P.CodeSpec("k17r2", 17, 2, (0o247461, 0o323475))
INV29 = P.CodeSpec("inv29", 9, 2, (-P.VITERBI29.polys[0], P.VITERBI29.polys[1]))
# (code, mesh axes, B, T, entry metrics near the int32 limit)
CASES = [(P.VITERBI29, {"state": 2}, 3, 6, False), (P.VITERBI29, {"state": 4}, 1, 6, True),
         (P.VITERBI29, {"state": 8}, 8, 6, False), (INV29, {"state": 4}, 3, 6, True),
         (P.VITERBI615, {"state": 4}, 3, 5, True), (K17, {"state": 4}, 1, 4, False),
         (K17, {"state": 4}, 8, 3, True), (P.VITERBI29, {"state": 4, "time": 2}, 3, 6, True)]
case_id = lambda c: f"{c[0].name}-{'x'.join(f'{k}{v}' for k, v in c[1].items())}-B{c[2]}" + (  # noqa: E731
    "-near" if c[4] else "")


def _bits(x: torch.Tensor, n: int = 32) -> torch.Tensor:
    """``[..., n]`` the low n bits of int64 ``x``."""
    return (x[..., None] >> torch.arange(n)) & 1


def _spread16(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``spread16``: 16 bits to the even bits of a word."""
    x = x & 0xFFFF
    for sh, m in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        x = (x | (x << sh)) & m
    return x


@functools.lru_cache(maxsize=None)
def _penalty_index(code, base, chunk):
    """The kernel's ``pidx`` for the lanes of a shard's warps: the popcount
    parity of ``s2 & mask_r`` of the global ``s2 = base + s2_loc``, bit r."""
    masks, _ = shard.step_constants(code)
    s2 = base + torch.arange(32 * -(-chunk // 32))
    return sum((_bits(s2 & m).sum(-1) & 1) << r for r, m in enumerate(masks))


def replay(code, lo, hi, s2_base, tables, t, m_out, dec_row):
    """The kernel's launch in plain torch, with the launcher's arguments:
    warps of 32 lanes over ``s2_loc``, lanes past ``chunk`` masked."""
    n, B, n_local = m_out.shape
    chunk = n_local // 2
    _, offs = shard.step_constants(code)
    warps = -(-chunk // 32)
    s2_loc = torch.arange(32 * warps)
    live = s2_loc < chunk
    src = s2_loc.clamp(max=chunk - 1)
    for j in range(n):
        pidx = _penalty_index(code, s2_base[j], chunk)
        trow = tables[j, :, t].long()  # [B, 2^R]
        pen = [trow[:, pidx ^ c] for c in offs]  # [B, 32 warps] each
        old_lo, old_hi = lo[j].long()[:, src], hi[j].long()[:, src]
        c_lo = [wrap_int32(old_lo + pen[bit]) for bit in (0, 1)]
        c_hi = [wrap_int32(old_hi + pen[2 + bit]) for bit in (0, 1)]
        d = [(c_hi[bit] < c_lo[bit]) & live for bit in (0, 1)]
        new = torch.stack([torch.where(d[bit], c_hi[bit], c_lo[bit]) for bit in (0, 1)], -1)
        m_out[j] = new.reshape(B, -1)[:, :n_local]
        if dec_row is None:
            continue
        lane = torch.arange(32)
        b0, b1 = ((x.reshape(B, warps, 32).long() << lane).sum(-1) for x in d)  # the ballots
        words = torch.stack([_spread16(b0 >> sh) | (_spread16(b1 >> sh) << 1) for sh in (0, 16)],
                            -1).reshape(B, 2 * warps)
        dec_row[j] = wrap_int32(words[:, :dec_row.shape[-1]])


def _step_inputs(code, axes, B, T, near, seed):
    """``(mesh, m0 [n, B, n_local], sym [n, B, T, R])`` on the CPU: random
    entry metrics (a quarter of them within 600 of the int32 limit where
    ``near``) and random soft16 symbols, each shard its own."""
    mesh = par.Mesh(axes, "cpu")
    rng = np.random.default_rng(seed)
    n_local = code.num_states // axes["state"]
    m0 = rng.integers(0, 5000, size=(mesh.n_local, B, n_local))
    if near:
        top = rng.random(m0.shape) < 0.25
        m0[top] = (2**31 - 1) - rng.integers(0, 600, size=int(top.sum()))
    numeric = P.soft16_spec(code.R)
    sym = rng.integers(numeric.soft_low, numeric.soft_high + 1, size=(mesh.n_local, B, T, code.R))
    return mesh, torch.from_numpy(m0.astype(np.int32)), torch.from_numpy(sym.astype(np.int32))


def _pidx(code, mesh):
    _, s2_block, _ = statewise._shard_geometry(code, mesh, "state")
    return statewise._parity_index(code, s2_block)


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors routed as on a card (``_on_kernel`` true), the launcher
    replaced by the replay; returns the steps it was called for."""
    calls = []

    def fake_launch(code, lo, hi, s2_base, tables, t, m_out, dec_row):
        calls.append(t)
        replay(code, lo, hi, s2_base, tables, t, m_out, dec_row)

    monkeypatch.setattr(statewise, "_on_kernel", lambda device: True)
    monkeypatch.setattr(shard, "sharded_acs_step", fake_launch)
    return calls


def test_step_constants_are_the_plain_versions():
    for code in (P.VITERBI29, INV29, P.VITERBI615, K17, P.VITERBI224):
        masks, offs = shard.step_constants(code)
        assert masks == tuple(p >> 1 for p in code.abs_polys())
        plain = statewise._pattern_offsets(code)
        assert offs == tuple(plain[(h, bit)] for h in (0, 1) for bit in (0, 1))


@pytest.mark.parametrize("record", [True, False], ids=["words", "no-words"])
@pytest.mark.parametrize("steps", ["one", "whole"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_replayed_scan_equals_plain_scan(card_route, case, steps, record):
    """The card's route with the replayed kernel against the plain scan:
    metrics and every word, one step and whole scans; one launch a step."""
    code, axes, B, T, near = case
    T = 1 if steps == "one" else T
    mesh, m0, sym = _step_inputs(code, axes, B, T, near, code.K * B)
    args = (mesh, code, P.soft16_spec(code.R), m0, sym, "state", _pidx(code, mesh), record)
    m_k, d_k = statewise._sharded_acs_scan(*args)
    m_r, d_r = statewise._sharded_acs_scan_ref(*args)
    assert card_route == list(range(T))
    assert torch.equal(m_k, m_r)
    assert (d_k is None and d_r is None) if not record else torch.equal(d_k, d_r)
    if near:
        assert (m_r < 0).any()  # some adds wrapped


def test_cpu_route_is_the_plain_version(monkeypatch):
    """On the CPU the scan is the plain version: the launcher is never reached."""
    def refuse(*a):
        raise AssertionError("the launcher was reached on the CPU")

    monkeypatch.setattr(shard, "sharded_acs_step", refuse)
    assert statewise._on_kernel(torch.device("cuda")) and statewise._on_kernel(
        torch.device("cuda", 0)) and not statewise._on_kernel(torch.device("cpu"))
    _, sym = _frames(P.VITERBI29, "noisy")
    bits = par.state_sharded_decode_bits(P.VITERBI29, P.soft8_spec(2), sym,
                                         par.Mesh({"state": 4}, "cpu"))
    np.testing.assert_array_equal(bits.numpy(), _jax_state_sharded(P.VITERBI29, 32, 4)[
        2:4])


# -- the exchange ----------------------------------------------------------------------


@pytest.mark.parametrize("axes", [{"state": 2}, {"state": 4}, {"state": 8},
                                  {"state": 2, "time": 2}, {"time": 2, "state": 4}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_ppermute_sources_equal_the_exchange(axes):
    """Each target's low and high chunks equal ``_exchange``'s, read as
    views of the operand (no copy in one process), and the recorded calls
    are the same four ``ppermute``s."""
    code = P.VITERBI29
    mesh = par.Mesh(axes, "cpu")
    n_dev = axes["state"]
    chunk = code.num_states // (2 * n_dev)
    m = torch.from_numpy(np.random.default_rng(n_dev).integers(
        -1000, 1000, size=(mesh.n_local, 3, 2 * chunk)).astype(np.int32))
    perm_lo, perm_hi = statewise.butterfly_perms(n_dev)
    with mesh_mod.recording() as want_calls:
        lo, hi = statewise._exchange(mesh, m, chunk, "state", perm_lo, perm_hi)
    halves = (m[..., :chunk], m[..., chunk:])
    with mesh_mod.recording() as calls:
        lo0, lo1, hi0, hi1 = mesh.ppermute_sources(
            "state", (halves[0], perm_lo[0]), (halves[1], perm_lo[1]),
            (halves[0], perm_hi[0]), (halves[1], perm_hi[1]))
    assert calls == want_calls and len(calls) == 4
    for j in range(mesh.n_local):
        for want, pair in ((lo[j], (lo0[j], lo1[j])), (hi[j], (hi0[j], hi1[j]))):
            got = [x for x in pair if x is not None]
            assert len(got) == 1 and torch.equal(got[0], want)
            assert got[0].untyped_storage().data_ptr() == m.untyped_storage().data_ptr()


def test_ppermute_sources_refuses_a_non_permutation():
    mesh = par.Mesh({"state": 4}, "cpu")
    with pytest.raises(ValueError, match="not a permutation"):
        mesh.ppermute_sources("state", (torch.zeros(4, 2), [(0, 1), (2, 1)]))


# -- the card's route against the JAX package ---------------------------------------------

SW_SHAPES = [(P.VITERBI29, 32, 2), (P.VITERBI29, 32, 4), (P.VITERBI29, 32, 8),
             (P.VITERBI615, 4, 4)]
ST_MESHES = [(2, 2), (4, 2), (2, 4)]


@functools.lru_cache(maxsize=None)
def _all_frames(code, n_bytes):
    """Six frames, ``test_torch_parallel.py``'s kinds two each (clean, noisy,
    erasure): ``(data [6, n_bytes], symbols [6, T, R] int32)``."""
    numeric = P.soft8_spec(code.R)
    rng = np.random.default_rng([code.K, code.R, n_bytes])
    data = rng.integers(0, 256, size=(6, n_bytes), dtype=np.uint8)
    sym = encode_frames(code, numeric, torch.from_numpy(data)).numpy().reshape(6, -1, code.R)
    sym[2:4] += rng.integers(-2, 3, size=sym[2:4].shape)
    T = sym.shape[1]
    sym[4:, T // 3:2 * T // 3] = (numeric.soft_high + numeric.soft_low) // 2
    return data, np.clip(sym, numeric.soft_low, numeric.soft_high).astype(np.int32)


def _frames(code, kind, n_bytes=32):
    data, sym = _all_frames(code, n_bytes)
    k = ("clean", "noisy", "erasure").index(kind)
    return data[2 * k:2 * k + 2], sym[2 * k:2 * k + 2]


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    import ka9q_viterbi_comparison_tpu as J
    import ka9q_viterbi_comparison_tpu.parallel as JPar
    return jax, jnp, JMesh, J, JPar


def _jcode(J, code):
    return {c.name: c for c in J.STANDARD_CODES}[code.name]


@functools.lru_cache(maxsize=None)
def _jax_state_sharded(code, n_bytes, n_dev):
    """JAX trellis bits of the six frames, one jitted call."""
    jax, jnp, JMesh, J, JPar = _jax()
    jmesh = JMesh(np.array(jax.devices()[:n_dev]), ("state",))
    fn = jax.jit(lambda s: JPar.state_sharded_decode_bits(_jcode(J, code), J.soft8_spec(code.R),
                                                          s, jmesh))
    return np.asarray(fn(jnp.asarray(_all_frames(code, n_bytes)[1])))


@functools.lru_cache(maxsize=None)
def _jax_state_time(n_state, n_time):
    jax, jnp, JMesh, J, JPar = _jax()
    code = _jcode(J, P.VITERBI29)
    padded, _ = JPar.pad_to_time_blocks(code, J.soft8_spec(2),
                                        jnp.asarray(_all_frames(P.VITERBI29, 32)[1]), n_time)
    jmesh = JMesh(np.array(jax.devices()[:n_state * n_time]).reshape(n_state, n_time),
                  ("state", "time"))
    fn = jax.jit(lambda s: JPar.state_time_decode_bits(code, J.soft8_spec(2), s, jmesh,
                                                       overlap=32))
    return np.asarray(fn(padded))


@pytest.mark.parametrize("code,n_bytes,n_dev", SW_SHAPES,
                         ids=[f"{c.name}-{n}" for c, _, n in SW_SHAPES])
def test_card_route_state_sharded_matches_jax(card_route, code, n_bytes, n_dev):
    """One launch a trellis step; the six frames' bits equal the JAX
    package's; the collectives equal ``statewise_model``'s."""
    numeric = P.soft8_spec(code.R)
    data, sym = _all_frames(code, n_bytes)
    mesh = par.Mesh({"state": n_dev}, "cpu")
    out = []
    rep = comms.collective_trace(lambda: out.append(
        par.state_sharded_decode_bits(code, numeric, sym, mesh)))
    bits = out[0]
    T = sym.shape[1]
    assert card_route == list(range(T))
    np.testing.assert_array_equal(bits.numpy(), _jax_state_sharded(code, n_bytes, n_dev))
    model = comms.statewise_model(code, n_dev, 6, T)
    perms = [c for c in rep.collectives if c.prim == "ppermute"]
    assert rep.total_count("ppermute") == model["update_ppermutes"]
    assert sum(c.wire_bytes for c in perms) == model["step_wire_bytes"]
    assert rep.total_count("psum") == model["traceback_psums"] and rep.total_count() == 5 * T
    clean = bits[:2, code.K - 1:code.K - 1 + n_bytes * 8].numpy()
    np.testing.assert_array_equal(np.packbits(clean, axis=1), data[:2])


@pytest.mark.parametrize("n_state,n_time", ST_MESHES, ids=[f"{s}x{t}" for s, t in ST_MESHES])
def test_card_route_state_time_matches_jax(card_route, n_state, n_time):
    """Warm-up steps plus main steps, one launch each; bits equal the JAX
    package's; the state axis's collectives equal ``state_time_model``'s."""
    code, numeric, OL = P.VITERBI29, P.soft8_spec(2), 32
    _, sym = _all_frames(code, 32)
    padded, _ = par.pad_to_time_blocks(code, numeric, torch.from_numpy(sym), n_time)
    mesh = par.Mesh({"state": n_state, "time": n_time}, "cpu")
    out = []
    rep = comms.collective_trace(lambda: out.append(
        par.state_time_decode_bits(code, numeric, padded, mesh, overlap=OL)))
    bits = out[0]
    Tb = padded.shape[1] // n_time
    assert card_route == list(range(OL)) + list(range(Tb + OL))
    np.testing.assert_array_equal(bits.numpy(), _jax_state_time(n_state, n_time))
    model = comms.state_time_model(code, n_state, n_time, 6, padded.shape[1], overlap=OL)
    sperms = [c for c in rep.collectives if c.prim == "ppermute" and c.axes == ("state",)]
    assert sum(c.count for c in sperms) == model["update_ppermutes_per_device_stream"]
    assert sum(c.wire_bytes for c in sperms) == model["step_wire_bytes"]
    assert rep.total_count("psum") == model["traceback_psums"]


@pytest.mark.slow
def test_plain_ice_state_sharded_matches_jax():
    """The plain port at ICE (K=24) on state=4 against the JAX package: one
    noisy 2-byte frame (T = 39).  The other cases hold the sharded paths to
    JAX at K <= 15 only."""
    jax, jnp, JMesh, J, JPar = _jax()
    code, numeric = P.VITERBI224, P.soft8_spec(2)
    rng = np.random.default_rng(24)
    data = rng.integers(0, 256, size=(1, 2), dtype=np.uint8)
    sym = encode_frames(code, numeric, torch.from_numpy(data)).numpy().reshape(1, -1, 2)
    sym = np.clip(sym + rng.integers(-2, 3, size=sym.shape), -3, 3).astype(np.int32)
    bits = par.state_sharded_decode_bits(code, numeric, sym, par.Mesh({"state": 4}, "cpu"))
    jmesh = JMesh(np.array(jax.devices()[:4]), ("state",))
    want = jax.jit(lambda s: JPar.state_sharded_decode_bits(_jcode(J, code), J.soft8_spec(2), s,
                                                            jmesh))(jnp.asarray(sym))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want))


def test_launcher_refuses_what_the_kernel_does_not_take():
    """Wrong dtype, shape, strides or device, and more targets than a launch takes."""
    code = P.VITERBI29
    n, B, chunk = 2, 3, 64
    good = dict(lo=[torch.zeros(B, chunk, dtype=torch.int32)] * n,
                hi=[torch.zeros(B, chunk, dtype=torch.int32)] * n, s2_base=[0, chunk],
                tables=torch.zeros(n, B, 5, 4, dtype=torch.int32), t=0,
                m_out=torch.zeros(n, B, 2 * chunk, dtype=torch.int32),
                dec_row=torch.zeros(n, B, 4, dtype=torch.int32))

    def call(**kw):
        shard.sharded_acs_step(code, **{**good, **kw})

    with pytest.raises(ValueError, match="tables must be int32"):
        call(tables=good["tables"].long())
    with pytest.raises(ValueError, match=r"m_out must have shape \(2, 3, 128\)"):
        call(m_out=torch.zeros(n, B, chunk, dtype=torch.int32))
    with pytest.raises(ValueError, match="m_out must be contiguous"):
        call(m_out=torch.zeros(n, 2 * chunk, B, dtype=torch.int32).transpose(1, 2))
    with pytest.raises(ValueError, match="dec_row must have shape"):
        call(dec_row=torch.zeros(n, B, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="tables must be contiguous"):
        call(tables=torch.zeros(n, B, 4, 5, dtype=torch.int32).transpose(2, 3))
    with pytest.raises(ValueError, match=r"lo\[1\] must be unit-strided"):
        call(lo=[good["lo"][0], torch.zeros(B, 2 * chunk, dtype=torch.int32)[:, ::2]])
    with pytest.raises(ValueError, match=r"hi\[0\] must have shape"):
        call(hi=[torch.zeros(B, chunk + 1, dtype=torch.int32)] * n)
    with pytest.raises(ValueError, match="step 5 outside"):
        call(t=5)
    with pytest.raises(ValueError, match="tables must lie on the CUDA device"):
        call()
    with pytest.raises(ValueError, match="1 to 64 targets"):
        call(lo=good["lo"][:1] * 65, hi=good["hi"][:1] * 65, s2_base=[0] * 65)
    with pytest.raises(ValueError, match="1 to 64 targets"):
        call(hi=good["hi"][:1])
    with pytest.raises(ValueError, match="R <= 8"):
        shard.sharded_acs_step(P.CodeSpec("k3r9", 3, 9, (7,) * 9), **good)
    assert "sharded_acs_scan" in _build.LAUNCHES
    assert "viterbi_shard.cu" in _build.SOURCES


# -- two gloo processes -------------------------------------------------------------------

TIMEOUT_S = 180


def test_two_gloo_processes_read_in_place_and_received(tmp_path):
    """State x time on (state=2, time=2) and state sharding on state=4 over
    two processes, two shards each, on the card's route with the replayed
    kernel: every launch reads some chunks in place and some received; bits
    equal the JAX package's; one launch a step."""
    _, sym = _all_frames(P.VITERBI29, 32)
    padded, _ = par.pad_to_time_blocks(P.VITERBI29, P.soft8_spec(2), torch.from_numpy(sym), 2)
    np.savez(tmp_path / "input.npz", sym=sym, padded=padded.numpy())
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", init, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"SHARD_WORKER_OK rank={r}" in out, out[-3000:]
    Tb = padded.shape[1] // 2
    for r in range(2):
        o = np.load(tmp_path / f"rank{r}.npz")
        np.testing.assert_array_equal(o["state_time"], _jax_state_time(2, 2))
        np.testing.assert_array_equal(o["state_sharded"], _jax_state_sharded(P.VITERBI29, 32, 4))
        assert list(o["launches"]) == [32 + Tb + 32, sym.shape[1]]
        assert o["in_place"].all() and o["received"].all()


def _gloo_worker(rank: int, world: int, init: str, out_dir: pathlib.Path) -> None:
    """One process of the gloo case: the card's route with the replay,
    counting each launch's chunks read in place (the operand's half, batch
    stride ``2 chunk``) and received (a buffer, batch stride ``chunk``)."""
    from ka9q_viterbi_comparison_tpu_torch.parallel import multihost

    multihost.initialize(init, world, rank, device="cpu")
    inp = np.load(out_dir / "input.npz")
    seen = []

    def launch(code, lo, hi, s2_base, tables, t, m_out, dec_row):
        chunk = m_out.shape[-1] // 2
        strides = [x.stride(0) for x in lo + hi]
        seen.append((2 * chunk in strides, chunk in strides))
        replay(code, lo, hi, s2_base, tables, t, m_out, dec_row)

    statewise._on_kernel = lambda device: True
    shard.sharded_acs_step = launch
    code, numeric = P.VITERBI29, P.soft8_spec(2)
    st = par.state_time_decode_bits(code, numeric, torch.from_numpy(inp["padded"]),
                                    par.Mesh({"state": 2, "time": 2}, "cpu"), overlap=32)
    n_st = len(seen)
    sw = par.state_sharded_decode_bits(code, numeric, torch.from_numpy(inp["sym"]),
                                       par.Mesh({"state": 4}, "cpu"))
    torch.distributed.destroy_process_group()
    np.savez(out_dir / f"rank{rank}.npz", state_time=st.numpy(), state_sharded=sw.numpy(),
             launches=[n_st, len(seen) - n_st], in_place=[s[0] for s in seen],
             received=[s[1] for s in seen])
    print(f"SHARD_WORKER_OK rank={rank}")


# -- on the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("record", [True, False], ids=["words", "no-words"])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cuda_kernel_equals_plain_scan(cuda_device, case, record):
    """The kernel's scan against the plain scan on the card: metrics and
    words, one launch a step."""
    code, axes, B, T, near = case
    mesh, m0, sym = _step_inputs(code, axes, B, T, near, code.K * B + 1)
    mesh = par.Mesh(axes, cuda_device)
    args = (mesh, code, P.soft16_spec(code.R), m0.cuda(), sym.cuda(), "state",
            _pidx(code, mesh), record)
    n = _build.LAUNCHES["sharded_acs_scan"]
    m_k, d_k = statewise._sharded_acs_scan(*args)
    assert _build.LAUNCHES["sharded_acs_scan"] == n + T
    m_r, d_r = statewise._sharded_acs_scan_ref(*args)
    assert torch.equal(m_k, m_r)
    assert (d_k is None and d_r is None) if not record else torch.equal(d_k, d_r)


if __name__ == "__main__":
    _gloo_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4]))
