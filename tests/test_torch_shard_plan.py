"""The launch plans of the state-sharded scan and traceback, and the planned collectives.

``shard.StepPlan`` checks a scan's layouts, binds the launcher and builds
its ctypes arguments once; a step is one launcher call.  ``Mesh.plan_exchange``
plans the butterfly exchange once (receive buffers, ``P2POp`` lists), and
``Mesh.plan_psum`` the traceback's ``psum`` a step on a fixed buffer
(``shard.WalkStepPlan`` launches the step kernel between them).

Here, on the CPU with the card's route pinned and the launchers replayed
on the plans' own arguments (``test_torch_shard_kernel.py`` and
``test_torch_shard_walk.py``): the plans, their ctypes arrays and their
exchanges are built once a scan, whatever its steps; the whole decodes on
the planned step route equal the JAX package's on the state-sharded and
state x time meshes; the planned exchange equals ``ppermute_sources`` and
the planned reduction sums and records as ``Mesh.psum`` does (two processes:
the gloo cases of those files); the plans refuse at build what the kernels
do not take; and a step over 65535 and 65536 frames, one and two kernel
launches, equals the plain scan.  Tolerance: exact equality (integer
arithmetic).
"""

import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu_torch import parallel as par
from ka9q_viterbi_comparison_tpu_torch.harness import comms
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, shard
from ka9q_viterbi_comparison_tpu_torch.parallel import mesh as mesh_mod
from ka9q_viterbi_comparison_tpu_torch.parallel import statewise
from test_torch_shard_kernel import (ST_MESHES, SW_SHAPES, _all_frames, _jax_state_sharded,
                                     _jax_state_time, _pidx, _step_inputs, launched_steps,
                                     pin_card_route, replay)
from test_torch_shard_walk import replay_step_launch

REPLAYS = {"viterbi_shard_step": replay, "viterbi_shard_walk_step": replay_step_launch}


@pytest.fixture
def planned(monkeypatch):
    """The card's route pinned with both plans' launchers replayed; the step
    route of the traceback taken (its lines as if they spanned processes);
    counts of what is built: plans bound, ctypes arrays, exchanges planned,
    reductions planned.  Returns ``(calls, built)``."""
    calls = pin_card_route(monkeypatch, REPLAYS)
    monkeypatch.setattr(statewise, "_walk_on_kernel", lambda device: True)
    monkeypatch.setattr(par.Mesh, "lines_in_process", lambda self, axis: None)
    built = {"bind": 0, "array": 0, "plan_exchange": 0, "plan_psum": 0}

    def counting(key, fn):
        def run(*args, **kwargs):
            built[key] += 1
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(shard, "_bind", counting("bind", shard._bind))
    monkeypatch.setattr(shard, "_array", counting("array", shard._array))
    for name in ("plan_exchange", "plan_psum"):
        monkeypatch.setattr(par.Mesh, name, counting(name, getattr(par.Mesh, name)))
    return calls, built


@pytest.mark.parametrize("axes", [{"state": 2}, {"state": 4, "time": 2}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_the_plans_are_built_once_a_scan(planned, axes):
    """A scan of 3 steps and one of 9 build the same: one step plan (its
    launcher bound once, a fixed set of ctypes arrays) and one exchange plan;
    a traceback one walk plan and two planned reductions; then one launcher
    call a step."""
    calls, built = planned
    code = P.VITERBI29
    counts = []
    for T in (3, 9):
        for key in built:
            built[key] = 0
        mesh, m0, sym = _step_inputs(code, axes, 2, T, False, T)
        before = len(calls)
        _, dec = statewise._sharded_acs_scan(mesh, code, P.soft16_spec(2), m0, sym, "state",
                                             _pidx(code, mesh), True)
        assert launched_steps(calls[before:]) == list(range(T))
        base, _, n_local = statewise._shard_geometry(code, mesh, "state")
        end = torch.zeros((mesh.n_local, 2), dtype=torch.int32)
        statewise._sharded_traceback(mesh, code, dec, end, base, n_local, "state")
        assert len(calls) - before == 2 * T  # a scan step and a traceback step
        counts.append(dict(built))
    assert counts[0] == counts[1]
    assert counts[0]["bind"] == 2 and counts[0]["plan_exchange"] == 1
    assert counts[0]["plan_psum"] == 2 and counts[0]["array"] == 3 + 4 * 2 + 1


@pytest.mark.parametrize("code,n_bytes,n_dev", SW_SHAPES,
                         ids=[f"{c.name}-{n}" for c, _, n in SW_SHAPES])
def test_planned_state_sharded_decode_matches_jax(planned, code, n_bytes, n_dev):
    """The whole decode on both plans (the step route of the traceback, a
    ``psum`` a step): bits equal the JAX package's, collectives equal
    ``statewise_model``'s, one scan launch and one walk-step launch a step."""
    calls, _ = planned
    _, sym = _all_frames(code, n_bytes)
    mesh = par.Mesh({"state": n_dev}, "cpu")
    out = []
    rep = comms.collective_trace(lambda: out.append(
        par.state_sharded_decode_bits(code, P.soft8_spec(code.R), sym, mesh)))
    T = sym.shape[1]
    assert [fn for fn, _ in calls] == ["viterbi_shard_step"] * T + ["viterbi_shard_walk_step"] * T
    np.testing.assert_array_equal(out[0].numpy(), _jax_state_sharded(code, n_bytes, n_dev))
    model = comms.statewise_model(code, n_dev, 6, T)
    assert rep.total_count("ppermute") == model["update_ppermutes"]
    assert rep.total_count("psum") == model["traceback_psums"] and rep.total_count() == 5 * T


@pytest.mark.parametrize("n_state,n_time", ST_MESHES, ids=[f"{s}x{t}" for s, t in ST_MESHES])
def test_planned_state_time_decode_matches_jax(planned, n_state, n_time):
    """State x time on both plans: bits equal the JAX package's, the ``psum``s
    ``state_time_model``'s."""
    code, numeric, OL = P.VITERBI29, P.soft8_spec(2), 32
    _, sym = _all_frames(code, 32)
    padded, _ = par.pad_to_time_blocks(code, numeric, torch.from_numpy(sym), n_time)
    mesh = par.Mesh({"state": n_state, "time": n_time}, "cpu")
    out = []
    rep = comms.collective_trace(lambda: out.append(
        par.state_time_decode_bits(code, numeric, padded, mesh, overlap=OL)))
    np.testing.assert_array_equal(out[0].numpy(), _jax_state_time(n_state, n_time))
    model = comms.state_time_model(code, n_state, n_time, 6, padded.shape[1], overlap=OL)
    assert rep.total_count("psum") == model["traceback_psums"]


@pytest.mark.parametrize("axes", [{"state": 2}, {"state": 8}, {"time": 2, "state": 4}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_planned_exchange_equals_ppermute_sources(axes):
    """In one process: each set's placed chunks are the views
    ``ppermute_sources`` returns (the same tensors' memory) and equal the
    plain exchange's chunks (``statewise._exchange`` on the same metrics),
    every run records the same four ``ppermute``s, and the placed views
    follow the operands' current contents."""
    code = P.VITERBI29
    mesh = par.Mesh(axes, "cpu")
    chunk = code.num_states // (2 * axes["state"])
    perm_lo, perm_hi = statewise.butterfly_perms(axes["state"])
    perms = (perm_lo[0], perm_lo[1], perm_hi[0], perm_hi[1])
    rng = np.random.default_rng(len(axes))
    bufs = torch.from_numpy(rng.integers(-99, 99, size=(2, mesh.n_local, 2, 3, chunk)).astype(
        np.int32))
    sets = [[bufs[p, :, h] for h in (0, 1, 0, 1)] for p in (0, 1)]
    exchanges = mesh.plan_exchange("state", perms, sets)
    for _ in range(2):
        bufs.random_(-99, 99)
        for xs, ex in zip(sets, exchanges):
            with mesh_mod.recording() as want_calls:
                want = mesh.ppermute_sources("state", *zip(xs, perms))
            with mesh_mod.recording() as calls:
                ex.run()
            assert calls == want_calls and len(calls) == 4 and ex.ops == []
            for got_move, want_move in zip(ex.placed, want):
                for got, w in zip(got_move, want_move):
                    assert (got is None) == (w is None)
                    if got is not None:
                        assert torch.equal(got, w) and got.data_ptr() == w.data_ptr()
            m = torch.cat([xs[0], xs[1]], dim=-1)  # the metrics [n, B, 2 chunk] the set halves
            lo, hi = statewise._exchange(mesh, m, chunk, "state", perm_lo, perm_hi)
            for j in range(mesh.n_local):
                for plain, pair in ((lo[j], ex.placed[0:2]), (hi[j], ex.placed[2:4])):
                    got = [x[j] for x in pair if x[j] is not None]
                    assert len(got) == 1 and torch.equal(got[0], plain)


@pytest.mark.parametrize("axes", [{"state": 4}, {"state": 2, "time": 2}, {"time": 3, "state": 2},
                                  {"state": 1, "time": 2}],
                         ids=lambda a: "x".join(f"{k}{v}" for k, v in a.items()))
def test_planned_reduction_equals_psum(axes):
    """In one process: ``plan_psum`` records what ``psum`` records and sums
    as it does, run after run on the buffer's current contents; where every
    group holds one local shard it sums in place."""
    mesh = par.Mesh(axes, "cpu")
    x = torch.zeros((mesh.n_local, 5), dtype=torch.int32)
    red = mesh.plan_psum(x, "state")
    assert (red.out is x) == (axes["state"] == 1)
    for seed in range(2):
        x.copy_(torch.from_numpy(np.random.default_rng(seed).integers(
            -50, 50, size=tuple(x.shape)).astype(np.int32)))
        with mesh_mod.recording() as want_calls:
            want = mesh.psum(x, "state")
        with mesh_mod.recording() as calls:
            got = red.run()
        assert calls == want_calls and len(calls) == 1
        assert got is red.out and torch.equal(got, want)


def test_plans_refuse_what_the_kernels_do_not_take():
    """At build: wrong layouts of a configuration, a step's row of words that
    is not contiguous, stores of state pairs that would not be aligned, a
    device that is not a card; a step outside the tables; a strided send, a
    strided reduction buffer."""
    code = P.VITERBI29
    n, B, chunk, T = 2, 3, 64, 5
    lo = [torch.zeros(B, chunk, dtype=torch.int32)] * n
    out = torch.zeros((n, 2, B, chunk), dtype=torch.int32)
    tables = torch.zeros((n, B, T, 4), dtype=torch.int32)
    dec = torch.zeros((T, n, B, 4), dtype=torch.int32)

    def plan(**kw):
        args = dict(sources=[(lo, lo, out)], s2_base=[0, chunk], tables=tables, dec=dec)
        return shard.StepPlan(code, **{**args, **kw})

    with pytest.raises(ValueError, match=r"m_out must have shape \(2, 2, 3, 64\)"):
        plan(sources=[(lo, lo, out), (lo, lo, out[:, :1])])
    with pytest.raises(ValueError, match="m_out must be unit-strided along the states"):
        plan(sources=[(lo, lo, torch.zeros((n, 2, B, 2 * chunk), dtype=torch.int32)[..., ::2])])
    with pytest.raises(ValueError, match="half-major .* or interleaved"):
        plan(sources=[(lo, lo, torch.zeros((n, 2, B, chunk + 1), dtype=torch.int32)[..., :chunk])])
    with pytest.raises(ValueError, match="8-byte aligned"):
        plan(sources=[(lo, lo, torch.zeros(n * 2 * B * chunk + 1, dtype=torch.int32)[1:].view(
            n, 2, B, chunk))])
    with pytest.raises(ValueError, match="each step's row of dec must be contiguous"):
        plan(dec=torch.zeros((T, B, n, 4), dtype=torch.int32).transpose(1, 2))
    with pytest.raises(ValueError, match=r"hi\[1\] must have shape"):
        plan(sources=[(lo, [lo[0], lo[0][:, 1:]], out)])
    with pytest.raises(ValueError, match="tables must lie on the CUDA device"):
        plan()
    with pytest.raises(ValueError, match="1 to 64 targets"):
        plan(s2_base=[0])
    bits = torch.zeros((n, B, T), dtype=torch.uint8)
    state = torch.zeros((n, B), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"bit_out\[1\] must have shape \(2, 3\)"):
        shard.WalkStepPlan(code, dec, state, [0, 1], 128, bits, [state, state[:1]], [])
    with pytest.raises(ValueError, match="dec must lie on a CUDA device"):
        shard.WalkStepPlan(code, dec, state, [0, 1], 128, bits, [state, state], [state])
    mesh = par.Mesh({"state": 2}, "cpu")
    with pytest.raises(ValueError, match="the buffer must be contiguous"):
        mesh.plan_psum(torch.zeros((3, 2), dtype=torch.int32).T, "state")
    with pytest.raises(ValueError, match="one shape and dtype a move"):
        mesh.plan_exchange("state", [[(0, 1)]], [[out[0]], [out[0, :1]]])


@pytest.fixture
def replayed(monkeypatch):
    return pin_card_route(monkeypatch, REPLAYS)


@pytest.mark.parametrize("B", [65535, 65536])
def test_a_step_splits_its_frames_into_launches(replayed, B):
    """K=7 on state=2 over 65535 and 65536 frames: one and two kernel
    launches a step, as the launcher reports them (runs of ``MAX_B``
    frames, replayed run by run), and the scan equals the plain scan,
    metrics and words."""
    code, T = P.VITERBI27, 2
    mesh = par.Mesh({"state": 2}, "cpu")
    numeric = P.soft16_spec(2)
    rng = np.random.default_rng(B)
    m0 = torch.from_numpy(rng.integers(0, 5000, size=(2, B, 32)).astype(np.int32))
    sym = torch.from_numpy(rng.integers(numeric.soft_low, numeric.soft_high + 1,
                                        size=(2, B, T, 2)).astype(np.int32))
    args = (mesh, code, numeric, m0, sym, "state", _pidx(code, mesh), True)
    before = _build.LAUNCHES["sharded_acs_scan"]
    m_k, d_k = statewise._sharded_acs_scan(*args)
    assert _build.LAUNCHES["sharded_acs_scan"] - before == T * -(-B // shard.MAX_B)
    assert launched_steps(replayed) == list(range(T))
    m_r, d_r = statewise._sharded_acs_scan_ref(*args)
    assert torch.equal(m_k, m_r) and torch.equal(d_k, d_r)
