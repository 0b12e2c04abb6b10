"""The state-sharded traceback's walk kernels: replayed, routed, across processes.

``sharded_walk_kernel`` (``csrc/viterbi_shard.cu``, launcher
``ops/cuda/shard.py`` ``sharded_walk``) runs the whole of
``parallel/statewise.py`` ``_sharded_traceback`` in one launch where every
state line lies in this process: a warp a (line, frame), lane L fetching the
word of the state ``d = floor(log2(L + 1))`` steps back on the decisions that
the bits of ``L + 1`` spell, the shard split ``s >> lg`` and ``s & (2^lg -
1)`` on its address, one ballot and a walk of the node tree resolving up to
five steps a round, each step's bit written to every shard of the line.
``sharded_walk_step_kernel`` (``sharded_walk_step``) runs one step where a
line spans processes: the state takes the previous step's ``psum`` in
place, and each shard's own bit goes to the next ``psum``.

Here both kernels are replayed in plain torch in that index arithmetic
(strides over the word storage, the line table, the ballot and the node
tree) and held to the plain version ``_sharded_traceback_ref``: K=3 and K=7
(a word wider than a shard), K=9 on state 1/2/4/8, K=15 and K=17 on state 4,
two (state, time) meshes in both axis orders, words where they lie in a
larger buffer, T of 1 and 23 (a last round short of five steps).  The card's
route is pinned on CPU tensors (the route predicates as on a card, the
launchers replaced by the replays): one walk launch a decode in one process
with the JAX module's ``psum`` a step recorded, or a step launch and a
``psum`` a step; bits equal to the JAX package's state-sharded and state x
time decodes, collectives equal to the models.  Two gloo processes run the
step route (lines across processes), the walk route (a time block a
process) and ``Mesh.psum``/``pmin``/``all_gather`` on meshes whose lines
mix local and remote shards, against plain reductions of the global data.
Cases marked ``cuda`` hold the kernels to the plain version on the card.
Tolerance: exact equality (integer arithmetic).
"""

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
from ka9q_viterbi_comparison_tpu_torch.parallel import mesh as mesh_mod
from ka9q_viterbi_comparison_tpu_torch.parallel import statewise
from test_torch_shard_kernel import (K17, ST_MESHES, SW_SHAPES, _all_frames, _jax_state_sharded,
                                     _jax_state_time, fake_binder, pin_card_route, resolve)
from test_torch_shard_kernel import replay as replay_scan

ROOT = pathlib.Path(__file__).resolve().parents[1]
K3 = P.CodeSpec("k3r2", 3, 2, (7, 5))
# (code, mesh axes): the lines, the shard split and the words a shard.
MESHES = [(K3, {"state": 2}), (P.VITERBI27, {"state": 4}), (P.VITERBI29, {"state": 1}),
          (P.VITERBI29, {"state": 2}), (P.VITERBI29, {"state": 4}), (P.VITERBI29, {"state": 8}),
          (P.VITERBI615, {"state": 4}), (K17, {"state": 4}),
          (P.VITERBI29, {"state": 4, "time": 2}), (P.VITERBI29, {"time": 2, "state": 4})]
mesh_id = lambda c: f"{c[0].name}-{'x'.join(f'{k}{v}' for k, v in c[1].items())}"  # noqa: E731
DEPTH = 5  # steps a round (kWalkDepth)


def _flat(dec: torch.Tensor) -> torch.Tensor:
    """The storage under ``dec`` from its first element, as int32 words."""
    return dec.as_strided((dec.untyped_storage().nbytes() // 4 - dec.storage_offset(),), (1,))


def replay_walk(code, dec, end, lines, n_local):
    """``sharded_walk``'s launch in plain torch: every (line, frame) warp at
    once, its 32 lanes as a last dimension."""
    T, n, B, _ = dec.shape
    st, sn, sb, _ = dec.stride()
    flat = _flat(dec)
    lg, nrot = n_local.bit_length() - 1, code.K - 1
    depth = min(DEPTH, nrot)
    line = torch.tensor(lines)  # [L, n_state]
    lane = torch.arange(32)
    d = torch.tensor([(L + 1).bit_length() - 1 for L in range(32)])
    cb = torch.tensor([int(f"{L + 1:b}"[1:][::-1] or "0", 2) for L in range(32)])  # the brev
    b = torch.arange(B)[None, :, None]
    pos = end.long()[line[:, 0]] & ((1 << nrot) - 1)  # [L, B]
    bits = torch.empty((n, B, T), dtype=torch.uint8)
    t = T - 1
    while t >= 0:
        nn = min(depth, t + 1)
        live = d < nn
        dd, cc = torch.where(live, d, 0), torch.where(live, cb, 0)
        cand = (pos[..., None] >> dd) | (cc << (nrot - dd))  # [L, B, 32]
        loc = cand & ((1 << lg) - 1)
        owner = line.gather(1, (cand >> lg).reshape(len(lines), -1)).reshape(cand.shape)
        word = flat[(t - dd) * st + owner * sn + b * sb + (loc >> 5)].long() & 0xFFFFFFFF
        kc = torch.where(live, (word >> (loc & 31)) & 1, 0)
        bal = (kc << lane).sum(-1)  # the ballot
        node = torch.zeros_like(pos)
        for _ in range(nn):
            node = 2 * node + 1 + ((bal >> node) & 1)
        path = (node + 1) ^ (1 << nn)
        for i in range(nn):
            for q in range(line.shape[1]):
                bits[line[:, q], :, t - nn + 1 + i] = ((path >> i) & 1).to(torch.uint8)
        brev = sum(((path >> (nn - 1 - e)) & 1) << e for e in range(nn))
        pos = (pos >> nn) | (brev << (nrot - nn))
        t -= nn
    return bits


def replay_step(K, dec, t, state, ksum, coords, n_local, bits, bit_out):
    """``sharded_walk_step``'s launch in plain torch, a thread a (shard, frame)."""
    _, n, B, _ = dec.shape
    st, sn, sb, _ = dec.stride()
    lg = n_local.bit_length() - 1
    if ksum is not None:
        bits[:, :, t + 1] = ksum.to(torch.uint8)
        state.copy_((state >> 1) | (ksum << (K - 2)))
    own = (state >> lg) == torch.tensor(coords, dtype=torch.int32)[:, None]
    loc = state.long() & ((1 << lg) - 1)
    off = t * st + torch.arange(n)[:, None] * sn + torch.arange(B)[None] * sb + (loc >> 5)
    word = _flat(dec)[torch.where(own, off, 0)]
    bit_out.copy_(torch.where(own, (word >> (loc & 31)) & 1, 0))


def replay_step_launch(tensors, dec, st, sn, sb, state, ksum, bits, bit_out, coords, n, lg, K, B,
                       T, t):
    """``viterbi_shard_walk_step`` in plain torch on a plan's own launcher
    arguments, every pointer resolved to the view it addresses in the plan's
    ``tensors``."""
    dec = resolve(tensors, dec, (T, n, B, -(-(1 << lg) // 32)), (st, sn, sb, 1))
    ksum = None if ksum is None else resolve(tensors, ksum, (n, B), (B, 1))
    replay_step(K, dec, t, resolve(tensors, state, (n, B), (B, 1)), ksum, list(coords)[:n],
                1 << lg, resolve(tensors, bits, (n, B, T), (B * T, T, 1), torch.uint8),
                resolve(tensors, bit_out, (n, B), (B, 1)))


def walk_routes(monkeypatch):
    """Both walk routes pinned: ``_walk_on_kernel`` true, ``sharded_walk``
    replaced by its replay and the step plan's launcher bound to the step's;
    returns the launches by counter."""
    calls = {"sharded_traceback": 0, "sharded_traceback_step": 0}

    def walk(*args):
        calls["sharded_traceback"] += 1
        return replay_walk(*args)

    def step(*args):
        calls["sharded_traceback_step"] += 1
        replay_step_launch(*args)

    monkeypatch.setattr(statewise, "_walk_on_kernel", lambda device: True)
    monkeypatch.setattr(shard, "sharded_walk", walk)
    return calls, step


@pytest.fixture
def walk_route(monkeypatch):
    """CPU tensors routed as on a card (``_walk_on_kernel`` true), both
    launchers replaced by their replays; returns the launches by counter."""
    calls, step = walk_routes(monkeypatch)
    monkeypatch.setattr(shard, "_card", lambda device: True)
    monkeypatch.setattr(shard, "_bind", fake_binder({"viterbi_shard_walk_step": step}, []))
    return calls


def _walk_inputs(code, axes, B, T, seed, in_place=False, device="cpu"):
    """``(mesh, dec [T, n, B, W], end [n, B], base, n_local)``: random words
    and a random end state a line and frame.  ``in_place``: the words are a
    view into a larger buffer (other strides, an offset)."""
    mesh = par.Mesh(axes, device)
    rng = np.random.default_rng(seed)
    base, _, n_local = statewise._shard_geometry(code, mesh, "state")
    W = -(-n_local // 32)
    words = rng.integers(-2**31, 2**31, size=(T, mesh.n_local, B, W), dtype=np.int64)
    words = torch.from_numpy(words.astype(np.int32)).to(device)
    if in_place:
        big = torch.zeros((T + 2, mesh.n_local, B, W + 3), dtype=torch.int32, device=device)
        dec = big[1:T + 1, :, :, 2:W + 2]
        dec.copy_(words)
    else:
        dec = words
    end = torch.empty((mesh.n_local, B), dtype=torch.int32)
    for ln in mesh._lines("state"):  # one process: the lines' shards are local indices
        end[ln] = torch.from_numpy(rng.integers(0, code.num_states, size=B).astype(np.int32))
    return mesh, dec, end.to(device), base, n_local


def _both(mesh, code, dec, end, base, n_local):
    """The routed traceback and the plain one, each with its recorded collectives."""
    with mesh_mod.recording() as got_calls:
        got = statewise._sharded_traceback(mesh, code, dec, end, base, n_local, "state")
    with mesh_mod.recording() as want_calls:
        want = statewise._sharded_traceback_ref(mesh, code, dec, end, base, n_local, "state")
    return got, want, got_calls, want_calls


@pytest.mark.parametrize("T", [1, 23])
@pytest.mark.parametrize("case", MESHES, ids=mesh_id)
def test_replayed_walk_equals_plain(walk_route, case, T):
    """One launch of the walk for the whole traceback, bits equal to the
    plain version's on every shard, the same ``psum``s recorded."""
    code, axes = case
    for in_place in (False, True):
        mesh, dec, end, base, n_local = _walk_inputs(code, axes, 3, T, code.K * T, in_place)
        got, want, got_calls, want_calls = _both(mesh, code, dec, end, base, n_local)
        assert torch.equal(got, want) and got.dtype == torch.uint8
        assert got_calls == want_calls and len(want_calls) == T
    assert walk_route == {"sharded_traceback": 2, "sharded_traceback_step": 0}


@pytest.mark.parametrize("case", MESHES, ids=mesh_id)
def test_replayed_steps_equal_plain(walk_route, monkeypatch, case):
    """The step route (lines taken as spanning processes): one step launch
    and one ``psum`` a step, bits equal to the plain version's."""
    code, axes = case
    monkeypatch.setattr(par.Mesh, "lines_in_process", lambda self, axis: None)
    T = 23
    mesh, dec, end, base, n_local = _walk_inputs(code, axes, 3, T, code.K + 1, True)
    got, want, got_calls, want_calls = _both(mesh, code, dec, end, base, n_local)
    assert torch.equal(got, want)
    assert got_calls == want_calls and len(want_calls) == T
    assert walk_route == {"sharded_traceback": 0, "sharded_traceback_step": T}


def test_lines_in_process_and_recorded_psums():
    """``lines_in_process``: the state lines as local shard indices in axis order;
    ``record_psums`` records what as many ``psum``s record."""
    assert par.Mesh({"state": 4}, "cpu").lines_in_process("state") == [[0, 1, 2, 3]]
    assert par.Mesh({"state": 4, "time": 2}, "cpu").lines_in_process("state") == [
        [0, 2, 4, 6], [1, 3, 5, 7]]
    assert par.Mesh({"time": 2, "state": 2}, "cpu").lines_in_process("state") == [[0, 1], [2, 3]]
    mesh = par.Mesh({"state": 2, "time": 2}, "cpu")
    x = torch.zeros((4, 5), dtype=torch.int32)
    with mesh_mod.recording() as want:
        for _ in range(3):
            mesh.psum(x, "state")
    with mesh_mod.recording() as got:
        mesh.record_psums(x, "state", 3)
    assert got == want and len(got) == 3 and got[0].payload_bytes == 20
    # A reduction's selectors: a slice where the rows are adjacent, else an index tensor.
    assert mesh._selector([1, 2, 3]) == slice(1, 4)
    assert torch.equal(mesh._selector([0, 2]), torch.tensor([0, 2]))


def test_cpu_route_is_the_plain_version(monkeypatch):
    """On the CPU the traceback is the plain version: no launcher is reached."""
    def refuse(*a):
        raise AssertionError("a walk launcher was reached on the CPU")

    monkeypatch.setattr(shard, "sharded_walk", refuse)
    monkeypatch.setattr(shard, "sharded_walk_step", refuse)
    assert statewise._walk_on_kernel(torch.device("cuda", 0))
    assert not statewise._walk_on_kernel(torch.device("cpu"))
    mesh, dec, end, base, n_local = _walk_inputs(P.VITERBI29, {"state": 4}, 2, 9, 5)
    got, want, _, _ = _both(mesh, P.VITERBI29, dec, end, base, n_local)
    assert torch.equal(got, want)


# -- the card's route against the JAX package ---------------------------------------------


@pytest.fixture
def card_route(monkeypatch):
    """The whole decode on the card's route: the scan's kernel replayed too."""
    calls, step = walk_routes(monkeypatch)
    pin_card_route(monkeypatch, {"viterbi_shard_step": replay_scan,
                                 "viterbi_shard_walk_step": step})
    return calls


@pytest.mark.parametrize("code,n_bytes,n_dev", SW_SHAPES,
                         ids=[f"{c.name}-{n}" for c, _, n in SW_SHAPES])
def test_card_route_state_sharded_matches_jax(card_route, code, n_bytes, n_dev):
    """One walk launch a decode; bits equal the JAX package's; the
    collectives equal ``statewise_model``'s, its ``psum`` a step recorded."""
    numeric = P.soft8_spec(code.R)
    _, sym = _all_frames(code, n_bytes)
    mesh = par.Mesh({"state": n_dev}, "cpu")
    out = []
    rep = comms.collective_trace(lambda: out.append(
        par.state_sharded_decode_bits(code, numeric, sym, mesh)))
    T = sym.shape[1]
    assert card_route == {"sharded_traceback": 1, "sharded_traceback_step": 0}
    np.testing.assert_array_equal(out[0].numpy(), _jax_state_sharded(code, n_bytes, n_dev))
    model = comms.statewise_model(code, n_dev, 6, T)
    assert rep.total_count("psum") == model["traceback_psums"] and rep.total_count() == 5 * T


@pytest.mark.parametrize("n_state,n_time", ST_MESHES, ids=[f"{s}x{t}" for s, t in ST_MESHES])
def test_card_route_state_time_matches_jax(card_route, n_state, n_time):
    """Both time blocks' tracebacks in one walk launch (the last block's halo
    words zeroed, the others from the global best state); bits equal the
    JAX package's; the ``psum``s equal ``state_time_model``'s."""
    code, numeric, OL = P.VITERBI29, P.soft8_spec(2), 32
    _, sym = _all_frames(code, 32)
    padded, _ = par.pad_to_time_blocks(code, numeric, torch.from_numpy(sym), n_time)
    mesh = par.Mesh({"state": n_state, "time": n_time}, "cpu")
    out = []
    rep = comms.collective_trace(lambda: out.append(
        par.state_time_decode_bits(code, numeric, padded, mesh, overlap=OL)))
    assert card_route == {"sharded_traceback": 1, "sharded_traceback_step": 0}
    np.testing.assert_array_equal(out[0].numpy(), _jax_state_time(n_state, n_time))
    model = comms.state_time_model(code, n_state, n_time, 6, padded.shape[1], overlap=OL)
    assert rep.total_count("psum") == model["traceback_psums"]


def test_card_route_steps_match_jax(card_route, monkeypatch):
    """The step route through a whole decode, in one process."""
    monkeypatch.setattr(par.Mesh, "lines_in_process", lambda self, axis: None)
    code, n_bytes, n_dev = SW_SHAPES[1]
    _, sym = _all_frames(code, n_bytes)
    bits = par.state_sharded_decode_bits(code, P.soft8_spec(2), sym, par.Mesh({"state": n_dev},
                                                                              "cpu"))
    assert card_route == {"sharded_traceback": 0, "sharded_traceback_step": sym.shape[1]}
    np.testing.assert_array_equal(bits.numpy(), _jax_state_sharded(code, n_bytes, n_dev))


# -- the launchers' refusals ----------------------------------------------------------------


def test_launchers_refuse_what_the_kernels_do_not_take():
    """Wrong dtype, shape, strides, device, lines, shard size, step or
    coordinates."""
    code = P.VITERBI29
    T, n, B, n_local = 5, 4, 3, 64
    dec = torch.zeros((T, n, B, 2), dtype=torch.int32)
    end = torch.zeros((n, B), dtype=torch.int32)
    lines = [[0, 1, 2, 3]]
    with pytest.raises(ValueError, match="lines of 4 shards"):
        shard.sharded_walk(code, dec, end, [[0, 1], [2, 3]], n_local)
    with pytest.raises(ValueError, match="each of the 4 local shards once"):
        shard.sharded_walk(code, dec, end, [[0, 1, 2, 2]], n_local)
    with pytest.raises(ValueError, match=r"dec must be \[T, n, B, W\] int32"):
        shard.sharded_walk(code, dec.long(), end, lines, n_local)
    with pytest.raises(ValueError, match="2 unit-strided words"):
        shard.sharded_walk(code, torch.zeros((T, n, B, 4), dtype=torch.int32)[..., ::2], end,
                           lines, n_local)
    with pytest.raises(ValueError, match="end must be int32"):
        shard.sharded_walk(code, dec, end.long(), lines, n_local)
    with pytest.raises(ValueError, match=r"end must have shape \(4, 3\)"):
        shard.sharded_walk(code, dec, end[:, :2], lines, n_local)
    with pytest.raises(ValueError, match="end must be contiguous"):
        shard.sharded_walk(code, dec, torch.zeros((B, n), dtype=torch.int32).T, lines, n_local)
    with pytest.raises(ValueError, match="dec must lie on a CUDA device"):
        shard.sharded_walk(code, dec, end, lines, n_local)
    with pytest.raises(ValueError, match="1 to 64 local shards"):
        shard.sharded_walk(P.VITERBI224, torch.zeros((T, 128, B, 1), dtype=torch.int32),
                           torch.zeros((128, B), dtype=torch.int32),
                           [list(range(128))], 1 << 16)

    bits = torch.zeros((n, B, T), dtype=torch.uint8)
    state, bit = end.clone(), end.clone()

    def step(**kw):
        args = dict(code=code, dec=dec, t=T - 1, state=state, ksum=None, coords=[0, 1, 2, 3],
                    n_local=n_local, bits=bits, bit_out=bit)
        shard.sharded_walk_step(**{**args, **kw})

    with pytest.raises(ValueError, match="must be a power of two"):
        step(n_local=48)
    with pytest.raises(ValueError, match="step 5 outside"):
        step(t=T)
    with pytest.raises(ValueError, match="a sum to apply needs a later step"):
        step(ksum=end.clone())
    with pytest.raises(ValueError, match="bits must be uint8"):
        step(bits=bits.int())
    with pytest.raises(ValueError, match=r"ksum must have shape \(4, 3\)"):
        step(t=0, ksum=end[:2])
    with pytest.raises(ValueError, match="state must be contiguous"):
        step(state=torch.zeros((B, n), dtype=torch.int32).T)
    with pytest.raises(ValueError, match="a coordinate below 4"):
        step(coords=[0, 1, 2, 4])
    with pytest.raises(ValueError, match="dec must lie on a CUDA device"):
        step()
    assert {"sharded_traceback", "sharded_traceback_step"} <= set(_build.LAUNCHES)
    assert {"viterbi_shard_walk", "viterbi_shard_walk_step"} <= set(_build._SIGNATURES)


# -- two gloo processes ---------------------------------------------------------------------

TIMEOUT_S = 180
# Meshes for the collectives: lines of local and remote shards, adjacent and
# not, one local line beside one that spans (time=3, state=2 over 2 processes).
REDUCE_MESHES = [{"state": 4}, {"state": 2, "time": 2}, {"state": 4, "time": 2},
                 {"time": 3, "state": 2}, {"frame": 2, "state": 2}]


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Two gloo processes, two or three shards each; returns their outputs."""
    tmp = tmp_path_factory.mktemp("walk_gloo")
    _, sym = _all_frames(P.VITERBI29, 32)
    padded, _ = par.pad_to_time_blocks(P.VITERBI29, P.soft8_spec(2), torch.from_numpy(sym), 2)
    np.savez(tmp / "input.npz", sym=sym, padded=padded.numpy())
    init = f"file://{tmp / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", init, str(tmp)],
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
        assert p.returncode == 0 and f"WALK_WORKER_OK rank={r}" in out, out[-3000:]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)], padded.shape[1] // 2


def test_two_gloo_processes_walk_across_and_within(gloo_run):
    """Lines across processes take the step route (a launch and a ``psum`` a
    step), a time block a process the walk route (one launch, its ``psum``s
    recorded); bits equal the JAX package's either way."""
    outs, Tb = gloo_run
    T = _all_frames(P.VITERBI29, 32)[1].shape[1]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["state_time"], _jax_state_time(2, 2))
        np.testing.assert_array_equal(o["state_sharded"], _jax_state_sharded(P.VITERBI29, 32, 4))
        np.testing.assert_array_equal(o["time_state"],
                                      _jax_state_time(4, 2)[:, r * Tb:(r + 1) * Tb])
        # (walk, step) launches and psums recorded: state x time, state sharding, time x state.
        assert o["launches"].tolist() == [[0, Tb + 32], [0, T], [1, 0]]
        assert o["psums"].tolist() == [Tb + 32, T, Tb + 32]


def test_two_gloo_processes_reduce_as_before(gloo_run):
    """``psum``, ``pmin``, ``all_gather`` and the planned ``psum`` (its
    second run, on new contents of its buffer) over the state axis equal
    plain reductions of the global data along each line; the planned
    ``psum`` records one ``psum`` a run."""
    outs, _ = gloo_run
    for i, axes in enumerate(REDUCE_MESHES):
        mesh = par.Mesh(axes, "cpu")
        x = _reduce_data(mesh.size)
        lines = {s: line for line in mesh._lines("state") for s in line}
        want_sum = np.stack([x[lines[s]].sum(0) for s in range(mesh.size)])
        want_min = np.stack([x[lines[s]].min(0) for s in range(mesh.size)])
        want_all = np.stack([x[lines[s]] for s in range(mesh.size)])
        for name, want in (("psum", want_sum), ("pmin", want_min), ("all_gather", want_all),
                           ("planned_psum", want_sum)):
            got = np.concatenate([o[f"{name}{i}"] for o in outs])
            np.testing.assert_array_equal(got, want, err_msg=f"{name} on {axes}")
        assert all(o[f"planned_psum_calls{i}"].all() for o in outs)


def _reduce_data(size):
    return np.random.default_rng(size).integers(-1000, 1000, size=(size, 3, 2)).astype(np.int32)


def _gloo_worker(rank: int, world: int, init: str, out_dir: pathlib.Path) -> None:
    """One process of the gloo cases: the decodes on the card's walk route
    with the replays, then the mesh's reductions."""
    from ka9q_viterbi_comparison_tpu_torch.parallel import multihost

    multihost.initialize(init, world, rank, device="cpu")
    inp = np.load(out_dir / "input.npz")
    launches = {"sharded_traceback": 0, "sharded_traceback_step": 0}

    def counted(name, fn):
        def run(*args):
            launches[name] += 1
            return fn(*args)
        return run

    statewise._walk_on_kernel = lambda device: True
    shard.sharded_walk = counted("sharded_traceback", replay_walk)
    shard._card = lambda device: True  # the scan's route too: its kernel replayed
    shard._bind = fake_binder({"viterbi_shard_step": replay_scan,
                               "viterbi_shard_walk_step": counted("sharded_traceback_step",
                                                                  replay_step_launch)}, [])
    code, numeric = P.VITERBI29, P.soft8_spec(2)
    padded = torch.from_numpy(inp["padded"])
    Tb = padded.shape[1] // 2
    runs = {
        "state_time": lambda: par.state_time_decode_bits(
            code, numeric, padded, par.Mesh({"state": 2, "time": 2}, "cpu"), overlap=32),
        "state_sharded": lambda: par.state_sharded_decode_bits(
            code, numeric, torch.from_numpy(inp["sym"]), par.Mesh({"state": 4}, "cpu")),
        "time_state": lambda: par.state_time_decode_bits(
            code, numeric, padded[:, rank * Tb:(rank + 1) * Tb],
            par.Mesh({"time": 2, "state": 4}, "cpu"), overlap=32),
    }
    out, counts, psums = {}, [], []
    for name, run in runs.items():
        before = dict(launches)
        with mesh_mod.recording() as calls:
            out[name] = run().numpy()
        counts.append([launches[k] - before[k] for k in ("sharded_traceback",
                                                         "sharded_traceback_step")])
        psums.append(sum(c.prim == "psum" for c in calls))
    for i, axes in enumerate(REDUCE_MESHES):
        mesh = par.Mesh(axes, "cpu")
        x = torch.from_numpy(_reduce_data(mesh.size))[mesh.first:mesh.first + mesh.n_local]
        out[f"psum{i}"] = mesh.psum(x, "state").numpy()
        planned = mesh.plan_psum(torch.zeros_like(x), "state")
        for data in (x.flip(-1), x):  # a second run sums the buffer's new contents
            planned.x.copy_(data)
            with mesh_mod.recording() as calls:
                got = planned.run()
            with mesh_mod.recording() as want:
                mesh.record_psums(x, "state", 1)
            out[f"planned_psum{i}"] = got.numpy()
            out[f"planned_psum_calls{i}"] = [calls == want]
        out[f"pmin{i}"] = mesh.pmin(x, "state").numpy()
        out[f"all_gather{i}"] = mesh.all_gather(x, "state").numpy()
    torch.distributed.destroy_process_group()
    np.savez(out_dir / f"rank{rank}.npz", launches=counts, psums=psums, **out)
    print(f"WALK_WORKER_OK rank={rank}")


# -- on the card ----------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["walk", "steps"])
@pytest.mark.parametrize("case", MESHES, ids=mesh_id)
def test_cuda_walk_equals_plain(cuda_device, monkeypatch, case, route):
    """The walk (one launch) and the step route (a launch a step) against
    the plain version on the card, on words that lie in a larger buffer."""
    code, axes = case
    T = 23
    if route == "steps":
        monkeypatch.setattr(par.Mesh, "lines_in_process", lambda self, axis: None)
    mesh, dec, end, base, n_local = _walk_inputs(code, axes, 3, T, code.K + 2, True, cuda_device)
    name = "sharded_traceback" if route == "walk" else "sharded_traceback_step"
    n = _build.LAUNCHES[name]
    got, want, got_calls, want_calls = _both(mesh, code, dec, end, base, n_local)
    assert _build.LAUNCHES[name] == n + (1 if route == "walk" else T)
    assert torch.equal(got, want) and got_calls == want_calls


if __name__ == "__main__":
    _gloo_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4]))
