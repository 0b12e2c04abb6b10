"""The port's multi-process decode: gloo processes on the CPU.

Each case starts ``tests/torch_multihost_worker.py`` in several processes
joined by a ``file://`` rendezvous under ``tmp_path`` (no port to collide
on between test workers), each with its own time limit.  They decode frame
DP (each its rows) and cross-process time blocks (each its block of the
same frames, the halos crossing the process boundary), and the larger case
the state axis across processes; the parent holds their outputs against the
JAX package's on its 8-device CPU mesh.  Tolerance: none.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu.parallel as JPar
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu_torch import parallel as par
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.parallel import multihost

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
TIMEOUT_S = 180


def _symbols(code, B, n_bytes, seed):
    numeric = P.soft8_spec(code.R)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(B, n_bytes), dtype=np.uint8)
    sym = encode_frames(code, numeric, torch.from_numpy(data)).numpy()
    sym = np.clip(sym + rng.integers(-2, 3, size=sym.shape), numeric.soft_low, numeric.soft_high)
    return sym.astype(np.int32)


def _run_workers(tmp_path, world, inputs):
    np.savez(tmp_path / "input.npz", **inputs)
    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), init,
                               str(tmp_path / "input.npz"), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
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
        assert p.returncode == 0, f"worker {r} failed:\n{out[-3000:]}"
        assert f"TORCH_MULTIHOST_OK rank={r}" in out, out[-3000:]
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def _jax_reference(code, frame_sym, time_sym, nbits, world, overlap):
    jcode = {c.name: c for c in J.STANDARD_CODES}[code.name]
    jnum = J.soft8_spec(code.R)
    tmesh = JMesh(np.array(jax.devices()[:world]), ("time",))
    # Under one jax.jit: the same program, compiled once, not dispatched op by op.
    frames = jax.jit(lambda s: JPar.frame_sharded_decode(jcode, jnum, s, nbits,
                                                         JPar.make_frame_mesh()))(frame_sym)
    bits = jax.jit(lambda s: JPar.time_block_decode_bits(jcode, jnum, s, tmesh, overlap))(
        time_sym)
    return np.asarray(frames), np.asarray(bits)


def _case(code, n_bytes, B, world, overlap):
    nbits = n_bytes * 8
    frame_sym = _symbols(code, B, n_bytes, 1)
    time_sym = _symbols(code, 2, n_bytes, 2).reshape(2, -1, code.R)
    mid = (P.soft8_spec(code.R).soft_high + P.soft8_spec(code.R).soft_low) // 2
    time_sym = np.pad(time_sym, ((0, 0), (0, (-time_sym.shape[1]) % world), (0, 0)),
                      constant_values=mid)
    return nbits, frame_sym, time_sym, {
        "code": code.name, "num_data_bits": nbits, "frame_symbols": frame_sym,
        "time_symbols": time_sym, "overlap": overlap}


def _check(outs, frames, bits):
    np.testing.assert_array_equal(np.concatenate([o["frames"] for o in outs]), frames)
    np.testing.assert_array_equal(np.concatenate([o["time_bits"] for o in outs], axis=1), bits)


def test_two_gloo_processes(tmp_path):
    """K=7, 64-byte frames: frame DP over 2 processes (8 rows each) and
    time blocks across them (T = 518, 259 steps a process)."""
    code, world, overlap = P.VITERBI27, 2, 56
    nbits, frame_sym, time_sym, inputs = _case(code, 64, 16, world, overlap)
    outs = _run_workers(tmp_path, world, inputs)
    _check(outs, *_jax_reference(code, frame_sym, time_sym, nbits, world, overlap))


@pytest.mark.slow
def test_four_gloo_processes_with_the_state_axis(tmp_path):
    """K=9, 128-byte frames over 4 processes, and VITERBI29 32-byte frames
    with the state axis across the 4 processes (ppermutes and psums cross
    the process boundary every step)."""
    code, world, overlap = P.VITERBI29, 4, 72
    nbits, frame_sym, time_sym, inputs = _case(code, 128, 16, world, overlap)
    state_sym = _symbols(P.VITERBI29, 2, 32, 3).reshape(2, -1, 2)
    inputs.update(state_code=P.VITERBI29.name, state_bits=32 * 8, state_symbols=state_sym)
    outs = _run_workers(tmp_path, world, inputs)
    _check(outs, *_jax_reference(code, frame_sym, time_sym, nbits, world, overlap))
    smesh = JMesh(np.array(jax.devices()[:world]), ("state",))
    want = jax.jit(lambda s: JPar.state_sharded_decode(J.VITERBI29, J.soft8_spec(2), s, 32 * 8,
                                                       smesh))(jnp.asarray(state_sym))
    for o in outs:
        np.testing.assert_array_equal(o["state_bytes"], np.asarray(want))


def test_meshes_and_process_groups_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    for make in (lambda: par.Mesh({"frame": 2}), lambda: par.make_frame_mesh(2),
                 lambda: multihost.global_frame_mesh(),
                 lambda: multihost.initialize(f"file://{tmp_path / 'rdzv'}", 1, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert par.backend_for("cuda") == "nccl" and par.backend_for("cpu") == "gloo"


def test_one_process_frame_batch_round_trip():
    """Without a process group, this process holds every shard: its rows as
    shards and back, and the frame decode of its rows."""
    mesh = multihost.global_frame_mesh(device="cpu")
    assert mesh.n_local == mesh.size == 1
    sym = _symbols(P.VITERBI27, 4, 16, 4)
    shards = multihost.global_frame_batch(sym, par.make_frame_mesh(2, device="cpu"))
    assert tuple(shards.shape) == (2, 2, sym.shape[1])
    np.testing.assert_array_equal(multihost.local_shard(shards), sym)
    out = multihost.decode_local_frames(P.VITERBI27, P.soft8_spec(2), sym, 16 * 8, mesh)
    want = P.decode_symbols(P.VITERBI27, P.soft8_spec(2), sym, 16 * 8, device="cpu")
    np.testing.assert_array_equal(out, want.numpy())
