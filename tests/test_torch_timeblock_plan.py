"""The time-block shard body on its plan.

``parallel/timeblock.py`` plans its body once per (mesh, shape): fixed
symbol buffers in the kernels' layout, the uniform and initial entry
metrics, each frame's start step and, across processes, one planned
exchange of both halos.  The walk takes the end state as the argmin of the
metrics and starts the last block from state 0 at ``Tb`` itself.  Here, on
the CPU: the planned body against the JAX ``time_block_decode_bits`` on the
meshes and frames that ``tests/test_torch_parallel.py`` compiles
(``TB_MESHES``, both routes, its cached ``_jax_time_block`` results), twice
on one mesh (the plan built once); the halo ``ppermute``s recorded against
``harness/comms.py``'s ``timeblock_model``; the walk's one call with its
start steps and metrics; and two gloo processes, spawned from this file's
``__main__``, whose one planned exchange a call gives the bits of the
in-process mesh.  Tolerance: none (bit-identical).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import ka9q_viterbi_comparison_tpu_torch as P  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch import parallel as par  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.harness import comms  # noqa: E402
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import dispatch, inplace, kernels  # noqa: E402

TIMEOUT_S = 120
OL = 56  # default_overlap(K=7)


def _plans(mesh):
    return [v for k, v in mesh._cache.items() if k[0] == "timeblock"]


@pytest.mark.parametrize("route", ["pair", "inplace"])
@pytest.mark.parametrize("mesh_name", ["f2t4", "t2"])
def test_planned_body_matches_jax(mesh_name, route, monkeypatch):
    """Both meshes and routes, noisy frames: the JAX bits on two calls of
    one mesh, the plan built once, one walk a call that reads the metrics
    and the start steps (no end-state tensor)."""
    from test_torch_parallel import TB_BATCHES, TB_MESHES, TB_ROWS, _frames, _jax_time_block, \
        _pad_erasure

    code = P.VITERBI27
    B = TB_BATCHES[(mesh_name, route)]
    axes = TB_MESHES[mesh_name]
    mesh = par.Mesh(axes, "cpu")
    calls = []
    mod, name = (inplace, "chainback_inplace") if route == "inplace" else (kernels, "chainback_tb")
    walk = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append((a[2], sorted(k))) or walk(*a, **k))
    sym = _pad_erasure(code, _frames(code, B, 64, "noisy")[1], axes["time"])
    k = list(("clean", "noisy", "erasure")).index("noisy")
    want = _jax_time_block(code, mesh_name)[k * TB_ROWS:k * TB_ROWS + B]
    for _ in range(2):
        np.testing.assert_array_equal(
            par.time_block_decode_bits(code, P.soft8_spec(2), sym, mesh).numpy(), want)
    plans = _plans(mesh)
    assert len(plans) == 1 and plans[0].route == route
    Tb = sym.shape[1] // axes["time"]
    last = plans[0].start == Tb
    assert int(last.sum()) == B // axes.get("frame", 1) * (mesh.n_local // axes["time"])
    assert bool((plans[0].start[~last] == Tb + OL).all())
    assert calls == [(None, ["form", "hi", "metrics", "metrics_phase", "out", "start"]
                      if route == "inplace" else ["metrics", "out", "start"])] * 2


@pytest.mark.parametrize("route", ["pair", "inplace"])
def test_body_updates_read_the_plan_buffers(route, monkeypatch):
    """The body's two whole-frame updates read the plan's own symbol buffers
    and write into its word buffers: nothing is copied for them (the body
    stays the blocks' copy, two halo ``index_select``s, the warm-up, one
    ``where``, the main update and the walk)."""
    from test_torch_parallel import TB_BATCHES, TB_MESHES, _frames, _pad_erasure

    code, B = P.VITERBI27, TB_BATCHES[("f2t4", route)]
    mesh = par.Mesh(TB_MESHES["f2t4"], "cpu")
    if route == "inplace":
        monkeypatch.setenv("KA9Q_TORCH_INPLACE", "1")
    seen = []

    def record(fn):
        def update(code, numeric, m, s, t_real, *rest, out=None):
            seen.append((s.data_ptr(), out.data_ptr()))
            return fn(code, numeric, m, s, t_real, *rest, out=out)
        return update

    if route == "inplace":
        monkeypatch.setattr(inplace, "acs_update_inplace", record(inplace.acs_update_inplace))
    else:
        real = dispatch._small_k_impl
        monkeypatch.setattr(dispatch, "_small_k_impl", lambda batch: record(real(batch)))
    sym = _pad_erasure(code, _frames(code, B, 64, "noisy")[1], 4)
    par.time_block_decode_bits(code, P.soft8_spec(2), sym, mesh)
    plan = _plans(mesh)[0]
    assert plan.route == route
    assert seen == [(plan.warm_sym.data_ptr(), plan.warm_words.data_ptr()),
                    (plan.main_sym.data_ptr(), plan.main_words.data_ptr())]


@pytest.mark.parametrize("axes", [{"time": 4}, {"frame": 2, "time": 4}, {"time": 8}])
def test_halo_ppermutes_follow_the_model(axes):
    """Each call records the two halo ``ppermute``s of the model, planned or
    not, with the payload of a ``[b, OL, R]`` int32 block."""
    code, B = P.VITERBI27, 4
    T = 8 * 80
    sym = np.random.default_rng(8).integers(0, 256, size=(B, T, 2)).astype(np.int32)
    mesh = par.Mesh(axes, "cpu")
    b = B // axes.get("frame", 1)
    model = comms.timeblock_model(code, axes["time"], b, T, overlap=OL)
    for _ in range(2):
        rep = comms.collective_trace(
            lambda: par.time_block_decode_bits(code, P.soft8_spec(2), sym, mesh, overlap=OL))
        perms = [c for c in rep.collectives if c.prim == "ppermute"]
        assert rep.total_count() == rep.total_count("ppermute") == model["halo_ppermutes"]
        assert all(c.payload_bytes == model["halo_payload_bytes"] and c.pairs == axes["time"] - 1
                   for c in perms)


def test_first_blocks_take_the_known_start_and_halos_are_index_ops():
    """In one process the exchange moves nothing (its halos are index ops
    on the blocks); the first block's frames enter from the known start
    state, the others from the warm-up."""
    code, B = P.VITERBI29, 3
    mesh = par.Mesh({"time": 4}, "cpu")
    sym = np.random.default_rng(9).integers(0, 256, size=(B, 4 * 100, 2)).astype(np.int32)
    par.time_block_decode_bits(code, P.soft8_spec(2), sym, mesh, overlap=30)
    plan, = _plans(mesh)
    assert plan.exchange.ops == [] and plan.route == "pair"
    assert plan.first.reshape(-1).tolist() == [True] * B + [False] * 3 * B
    blocks = torch.from_numpy(sym).reshape(B, 4, 100, 2)
    for i in range(4):
        src_l, src_r = max(i - 1, 0), min(i + 1, 3)
        frames = slice(i * B, (i + 1) * B)
        if i:
            assert torch.equal(plan.warm_sym[:, :, frames], blocks[:, src_l, -30:].permute(1, 2, 0))
        if i < 3:
            assert torch.equal(plan.main_sym[100:, :, frames], blocks[:, src_r, :30].permute(1, 2, 0))
        assert torch.equal(plan.main_sym[:100, :, frames], blocks[:, i].permute(1, 2, 0))


# -- two gloo processes -------------------------------------------------------------------


def _worker(rank: int, world: int, init: str, tmp: pathlib.Path) -> None:
    """One of the processes: its time blocks of the input on a mesh spread
    over the processes, twice (one plan, one exchange batch a call), and
    the counts."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    inp = np.load(tmp / "input.npz")
    out = {}
    for name, axes in (("t2", {"time": 2}), ("t4", {"time": 4}), ("f2t2", {"frame": 2, "time": 2})):
        mesh = par.Mesh(axes, "cpu")
        sym = inp[name]
        n_t = axes["time"]
        lo, ext = mesh._box(("frame" if "frame" in axes else None, "time"))
        Tq = sym.shape[1] // n_t
        rows = sym.shape[0] // axes.get("frame", 1)
        f0 = lo.get("frame", 0) * rows
        block = sym[f0:f0 + rows * ext.get("frame", 1), lo["time"] * Tq:(lo["time"] + ext["time"]) * Tq]
        batches = []
        real = dist.batch_isend_irecv
        dist.batch_isend_irecv = lambda ops: batches.append(len(ops)) or real(ops)
        try:
            rep = comms.collective_trace(lambda: [
                par.time_block_decode_bits(P.VITERBI27, P.soft8_spec(2), block, mesh, overlap=OL)
                for _ in range(2)])
            bits = par.time_block_decode_bits(P.VITERBI27, P.soft8_spec(2), block, mesh,
                                              overlap=OL)
        finally:
            dist.batch_isend_irecv = real
        out[f"{name}_bits"] = bits.numpy()
        out[f"{name}_batches"] = np.array(batches)
        out[f"{name}_ops"] = np.array([len(p.exchange.ops) for p in _plans(mesh)])
        out[f"{name}_perms"] = np.array(rep.total_count("ppermute"))
    dist.destroy_process_group()
    np.savez(tmp / f"rank{rank}.npz", **out)
    print(f"TB_WORKER_OK rank={rank}")


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tb_gloo")
    rng = np.random.default_rng(2026)
    syms = {name: np.clip(rng.integers(-200, 300, size=(B, T, 2)), -127, 127).astype(np.int32)
            for name, B, T in (("t2", 3, 2 * 120), ("t4", 2, 4 * 80), ("f2t2", 4, 2 * 90))}
    np.savez(tmp / "input.npz", **syms)
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
        assert p.returncode == 0 and f"TB_WORKER_OK rank={r}" in out, out[-3000:]
    return syms, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("name,axes", [("t2", {"time": 2}), ("t4", {"time": 4}),
                                       ("f2t2", {"frame": 2, "time": 2})])
def test_two_gloo_processes_equal_the_in_process_mesh(gloo_run, name, axes):
    """Each process's bits are its block of the in-process mesh's; a call
    is one exchange batch (a send and a receive a halo that crosses), the
    two halo ``ppermute``s recorded a call, one plan across the calls."""
    syms, outs = gloo_run
    whole = par.time_block_decode_bits(P.VITERBI27, P.soft8_spec(2), syms[name],
                                       par.Mesh(axes, "cpu"), overlap=OL).numpy()
    n_t = axes["time"]
    Tq = syms[name].shape[1] // n_t
    for r, o in enumerate(outs):
        mesh_r = par.Mesh(axes, "cpu")
        mesh_r.world, mesh_r.rank = 2, r
        mesh_r.n_local, mesh_r.first = mesh_r.size // 2, r * (mesh_r.size // 2)
        lo, ext = mesh_r._box(("frame" if "frame" in axes else None, "time"))
        rows = syms[name].shape[0] // axes.get("frame", 1)
        f0 = lo.get("frame", 0) * rows
        want = whole[f0:f0 + rows * ext.get("frame", 1),
                     lo["time"] * Tq:(lo["time"] + ext["time"]) * Tq]
        np.testing.assert_array_equal(o[f"{name}_bits"], want)
        crossing = sum(1 for perm in ([(i, i + 1) for i in range(n_t - 1)],
                                      [(i + 1, i) for i in range(n_t - 1)])
                       for s, d in mesh_r._pairs("time", tuple(perm))
                       if (mesh_r.owner(s) == r) != (mesh_r.owner(d) == r))
        assert o[f"{name}_ops"].tolist() == [crossing]
        # A process whose halos all stay inside it issues no batch (f2t2: a frame a process).
        assert o[f"{name}_batches"].tolist() == ([crossing] * 3 if crossing else [])
        assert int(o[f"{name}_perms"]) == 2 * comms.timeblock_model(
            P.VITERBI27, n_t, rows, Tq * n_t, overlap=OL)["halo_ppermutes"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 64])
def test_cuda_planned_body_equals_the_cpu(B, cuda_device):
    """On the card: the bits of the CPU's run of the same body (the pair
    route at B=4, the in-place pair at B=64 on four shards), the noiseless
    bits the unsharded decode's, three launches a call: the warm-up, the
    main ACS, the walk."""
    from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build
    from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames

    code, numeric = P.VITERBI27, P.soft8_spec(2)
    rng = np.random.default_rng(B)
    data = rng.integers(0, 256, size=(B, 64), dtype=np.uint8)
    clean = encode_frames(code, numeric, torch.from_numpy(data)).reshape(B, -1, 2)
    T = clean.shape[1]
    clean = torch.nn.functional.pad(clean, (0, 0, 0, (-T) % 4))
    noisy = torch.clamp(clean + torch.from_numpy(rng.integers(-3, 4, size=clean.shape)), -127, 127)
    axes = {"time": 4}
    for sym in (clean.to(torch.int32), noisy.to(torch.int32)):
        mesh = par.Mesh(axes, cuda_device)
        _build.reset_launch_counts()
        got = par.time_block_decode_bits(code, numeric, sym.to(cuda_device), mesh, overlap=OL)
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        route = dispatch.use_inplace(code, 4 * B, cuda_device)  # the folded batch
        want = {("acs_update_inplace" if route else "acs_update_tb"): 2,
                ("chainback_inplace" if route else "chainback_tb"): 1}
        assert launched == want
        cpu = par.time_block_decode_bits(code, numeric, sym, par.Mesh(axes, "cpu"), overlap=OL)
        assert torch.equal(got.cpu(), cpu)
    whole = P.decode_symbols(code, numeric, clean[:, :T].reshape(B, -1), 64 * 8, device="cuda")
    got = par.time_block_decode(code, numeric, clean.to(cuda_device), 64 * 8,
                                par.Mesh(axes, cuda_device), overlap=OL)
    assert torch.equal(got, whole)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], pathlib.Path(sys.argv[4]))
