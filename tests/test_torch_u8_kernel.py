"""The u8 replicas' kernel: its host table, its step replayed, its route.

``u8_warp_kernel<K, SPIRAL>`` (``csrc/viterbi_u8.cu``, wrapper
``ops/cuda/u8.py``) runs ``quantized_update`` / ``spiral_update`` on a CUDA
device at K <= 9: a warp a frame, new state ``n`` at lane ``n % 32`` of
register ``n // 32``, its predecessors by shuffles from the lanes of
``u8.lane_table``, its branch value one byte of the step's four, picked by
the table's pattern and butterfly bit.

Here the table is held against the JAX package's rail tables and the
butterfly, state by state, for K = 2..9 (and codes with inverted
polynomials for SPIRAL); the kernel's step is replayed from it in plain
torch (lanes as a tensor axis, a shuffle as a gather, a ballot as a pack of
the lanes' bits, the ka9q metrics in the top byte of a 32-bit word, SPIRAL's
one clamp a state) and held to the port's plain version ``_u8_update`` and
to the JAX ``quantized_update`` / ``spiral_update``, at
``test_torch_quantized.py``'s size (B=4, 48-byte frames); the route is
pinned (the launcher once an update on a CUDA device at K <= 9, the loop at
K >= 10 and on the CPU) with a monkeypatched launcher that runs the replay,
and the renormalisation threshold reaches the launcher as it reads at the
call.  Cases marked ``cuda`` hold the kernel against its plain version on
the card.  Tolerance: exact equality (integer arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_viterbi_comparison_tpu as J
import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu.ops import quantized as jq
from ka9q_viterbi_comparison_tpu_torch.convert import code_from_fields
from ka9q_viterbi_comparison_tpu_torch.ops import quantized as pq
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build, inplace, u8
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.utils.bits import wrap_int32

B, N_BYTES = 4, 48
CODES = [J.CodeSpec("k2r2", 2, 2, (0o3, 0o3)), J.CodeSpec("k3r2", 3, 2, (0o7, 0o5)),
         J.CodeSpec("k4r2", 4, 2, (0o15, 0o17)), J.CodeSpec("k5r2", 5, 2, (0o23, 0o35)),
         J.CodeSpec("k6r2", 6, 2, (0o65, 0o57)), J.VITERBI27,
         J.CodeSpec("k8r2", 8, 2, (0o247, 0o371)), J.VITERBI29]
# SPIRAL's tables carry the polynomial inversions (spiral27.cpp:67-71).
INVERTED = [J.CodeSpec("v27inv", 7, 2, (0o155, -0o117)), J.CodeSpec("k5inv", 5, 2, (-0o23, 0o35)),
            J.CodeSpec("v29inv", 9, 2, (-0x1AF, -0x11D))]
K10 = J.CodeSpec("k10r2", 10, 2, (0o1467, 0o1751))
FAMILIES = {"ka9q": False, "spiral": True}
ids = lambda c: c.name  # noqa: E731


def ported(jc):
    return code_from_fields(jc.name, jc.K, jc.R, jc.polys)


def tables_of(code, spiral):
    return pq._spiral_branch_tables(code) if spiral else pq.ka9q_branch_tables(code)


def cases():
    return ([(c, "ka9q") for c in CODES] + [(c, "spiral") for c in CODES + INVERTED])


def _stream(code, noise, seed=0):
    """``test_torch_quantized.py``'s streams: encoded frames plus uniform
    integer noise, clipped to 0..255, ``[B, T, 2]`` uint8."""
    rng = np.random.default_rng(seed + noise)
    data = rng.integers(0, 256, size=(B, N_BYTES), dtype=np.uint8)
    clean = encode_frames(code, P.ka9q_offset_binary_spec(), torch.from_numpy(data)).numpy()
    sym = np.clip(clean + rng.integers(-noise, noise + 1, size=clean.shape), 0, 255)
    return sym.astype(np.uint8).reshape(B, -1, 2)


@pytest.mark.parametrize("jc,family", cases(), ids=lambda x: x if isinstance(x, str) else x.name)
def test_lane_table_is_the_rail_tables_and_the_butterfly(jc, family):
    """Entry ``n`` of the table is state ``n % S`` (lanes past ``S`` copy a
    state): its pattern is the JAX rail tables' low bits at its butterfly
    ``s >> 1``, its butterfly bit ``s & 1``, its source lanes those of
    ``s >> 1`` and ``(s >> 1) + S/2``, whose registers are the kernel's
    compile-time ``r >> 1`` and ``(r >> 1) + NR/2`` (register 0 below 64
    states)."""
    code, spiral = ported(jc), FAMILIES[family]
    jt = np.asarray(jq._spiral_branch_tables(jc) if spiral else jq.ka9q_branch_tables(jc))
    assert set(np.unique(jt)) <= {0, 255}
    e = u8.lane_table(code, tables_of(code, spiral)).view(np.uint32).astype(np.int64)
    S = code.num_states
    NR = max(1, S // 32)
    assert e.shape == (max(S, 32),)
    for n, entry in enumerate(e):
        s, r = n % S, n // 32
        s2 = s >> 1
        assert entry & 3 == (jt[0, s2] & 1) | ((jt[1, s2] & 1) << 1)
        assert (entry >> 2) & 1 == s & 1 == n & 1  # the butterfly bit is the lane's parity
        assert (entry >> 3) & 0x1FFF == 0
        assert (entry >> 16) & 0xFF == s2 % 32 and entry >> 24 == (s2 + S // 2) % 32
        if NR > 1:
            assert (s2 // 32, (s2 + S // 2) // 32) == (r >> 1, (r >> 1) + NR // 2)


def replay(code, tables, metrics, symbols, Tp, threshold, spiral):
    """The kernel's sweep in plain torch, from its lane table: ``(metrics
    [B, S] uint8, words [Tp, W, B] int32)``, words past T zero."""
    nb, S = metrics.shape
    T = symbols.shape[1]
    NR = max(1, S // 32)
    e = torch.from_numpy(u8.lane_table(code, tables).view(np.uint32).astype(np.int64))
    e = e.reshape(NR, 32)
    pat, odd, slo, shi = e & 3, (e >> 2) & 1, (e >> 16) & 0xFF, e >> 24
    n = torch.arange(32 * NR).reshape(NR, 32)
    m = metrics.long()[:, n % S]  # [B, NR, 32]
    top, shift = (63, 2) if spiral else (15, 4)
    if not spiral:
        m = m << 24  # the top byte of the register
    reg = torch.arange(NR)
    rlo, rhi = ((reg >> 1)[:, None], ((reg >> 1) + NR // 2)[:, None]) if NR > 1 else (reg, reg)
    words = torch.zeros((Tp, code.decision_words, nb), dtype=torch.int32)
    sym = symbols.long()
    for t in range(T):
        s0, s1 = sym[:, t, 0], sym[:, t, 1]
        V = sum(((x0 + x1 + 1) >> (1 + shift)) << (8 * p) for p, (x0, x1) in
                enumerate(((s0, s1), (255 - s0, s1), (s0, 255 - s1), (255 - s0, 255 - s1))))
        V = V[:, None, None]
        Wv = torch.where(odd.bool(), top * 0x01010101 - V, V)
        la = (Wv >> (8 * pat)) & 0xFF  # byte_perm: byte p of the word
        lo, hi = m[:, rlo, slo], m[:, rhi, shi]
        if spiral:
            c_lo, c_hi = lo + la, torch.clamp(hi + top - la, max=255)
            d = c_hi <= c_lo
            m = torch.minimum(c_lo, c_hi)
            fire = m[:, 0, 0] > threshold
            m = torch.where(fire[:, None, None], m - m.amin(dim=(1, 2), keepdim=True), m)
        else:
            c_lo = (lo + (la << 24)) & 0xFFFFFFFF
            c_hi = (hi + (top << 24) - (la << 24)) & 0xFFFFFFFF
            diff = (c_lo - c_hi) & 0xFFFFFFFF
            d = (diff > 0) & (diff < 1 << 31)  # (int)(c_lo - c_hi) > 0
            m = torch.where(d, c_hi, c_lo)
        word = (d.long() << torch.arange(32)).sum(-1)  # the ballots, [B, NR]
        if S < 32:
            word &= (1 << S) - 1
        words[t] = wrap_int32(word).T
    m = m.reshape(nb, 32 * NR)[:, :S]
    return (m if spiral else m >> 24).to(torch.uint8), words


@pytest.mark.parametrize("jc,family", cases(), ids=lambda x: x if isinstance(x, str) else x.name)
def test_replayed_step_equals_plain_version(jc, family, monkeypatch):
    """The replay against ``_u8_update`` on random entry metrics (so that
    ka9q's adds wrap) and an all-noise stream (SPIRAL renormalises), at
    thresholds 210 and out of reach; a T that is no multiple of 32."""
    code, spiral = ported(jc), FAMILIES[family]
    rng = np.random.default_rng(code.K)
    m0 = torch.from_numpy(rng.integers(0, 256, size=(3, code.num_states), dtype=np.uint8))
    sym = torch.from_numpy(rng.integers(0, 256, size=(3, 77, 2), dtype=np.uint8))
    Tp = inplace.pad_time_inplace(code, 77)
    fired = []
    for thr in (210, 255):
        got = replay(code, tables_of(code, spiral), m0, sym, Tp, thr, spiral)
        monkeypatch.setattr(pq, "SPIRAL_RENORM_THRESHOLD", thr)
        want = pq._u8_update(code, m0, sym, spiral)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        fired.append(got[0])
    if spiral:
        assert not torch.equal(*fired)


@pytest.mark.parametrize("noise", [0, 127, 255])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("jc", [J.VITERBI27, J.VITERBI29], ids=ids)
def test_replayed_step_equals_jax(jc, family, noise):
    """The replay against the JAX update from ``init_metrics_u8`` on
    ``test_torch_quantized.py``'s streams: metrics and words."""
    code, spiral = ported(jc), FAMILIES[family]
    sym = _stream(code, noise)
    m_p, w_p = replay(code, tables_of(code, spiral), pq.init_metrics_u8(code, B, device="cpu"),
                      torch.from_numpy(sym), inplace.pad_time_inplace(code, sym.shape[1]),
                      pq.SPIRAL_RENORM_THRESHOLD, spiral)
    j_update = jq.spiral_update if spiral else jq.quantized_update
    m_j, w_j = j_update(jc, jq.init_metrics_u8(jc, B), jnp.asarray(sym))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    T = sym.shape[1]
    np.testing.assert_array_equal(w_p[:T].permute(2, 0, 1).contiguous().numpy().view(np.uint32),
                                  np.asarray(w_j))


def test_replayed_inverted_code_equals_jax():
    jc = INVERTED[0]
    code = ported(jc)
    sym = _stream(code, 127)
    m_p, _ = replay(code, tables_of(code, True), pq.init_metrics_u8(code, B, device="cpu"),
                    torch.from_numpy(sym), inplace.pad_time_inplace(code, sym.shape[1]),
                    pq.SPIRAL_RENORM_THRESHOLD, True)
    m_j, _ = jq.spiral_update(jc, jq.init_metrics_u8(jc, B), jnp.asarray(sym))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))


@pytest.mark.parametrize("jc", CODES + [K10, J.CodeSpec("k15r2", 15, 2, (0o70001, 0o43337))], ids=ids)
def test_route_by_device_and_k(jc):
    """The kernel on a CUDA device at K <= 9; the loop at K >= 10 there (no
    reference binary runs a u8 rate-1/2 replica at K >= 10) and on the CPU."""
    code = ported(jc)
    assert pq._on_kernel(code, torch.device("cuda")) == (code.K <= 9)
    assert pq._on_kernel(code, torch.device("cuda", 0)) == (code.K <= 9)
    assert not pq._on_kernel(code, torch.device("cpu"))


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors routed as CUDA ones (``_on_kernel`` as on a card), the
    launcher replaced by the replay; returns the launcher's calls."""
    calls = []

    def fake_launch(code, tables, metrics, symbols, Tp, threshold, spiral):
        calls.append((code.K, threshold, spiral, Tp))
        return replay(code, tables, metrics, symbols, Tp, threshold, spiral)

    monkeypatch.setattr(pq, "_on_kernel", lambda code, device: code.K <= u8.MAX_K)
    monkeypatch.setattr(u8, "launch_u8", fake_launch)
    return calls


@pytest.mark.parametrize("family", list(FAMILIES))
def test_card_route_launches_once_an_update(card_route, family):
    """One launch an update and one a decode, on the family's counter; the
    results are the plain version's and the JAX package's."""
    spiral = FAMILIES[family]
    jc = J.VITERBI27
    code = ported(jc)
    sym = _stream(code, 60)
    update = pq.spiral_update if spiral else pq.quantized_update
    m, w = update(code, pq.init_metrics_u8(code, B, device="cpu"), torch.from_numpy(sym))
    Tp = inplace.pad_time_inplace(code, sym.shape[1])
    assert card_route == [(7, pq.SPIRAL_RENORM_THRESHOLD, spiral, Tp)]
    m_r, w_r = pq._u8_update(code, pq.init_metrics_u8(code, B, device="cpu"),
                             torch.from_numpy(sym), spiral)
    assert torch.equal(m, m_r) and torch.equal(w, w_r[:sym.shape[1]].permute(2, 0, 1))
    decode = pq.decode_symbols_spiral if spiral else pq.decode_symbols_ka9q
    got = decode(code, sym.reshape(B, -1), N_BYTES * 8, device="cpu")
    assert len(card_route) == 2
    j_decode = jq.decode_symbols_spiral if spiral else jq.decode_symbols_ka9q
    want = np.asarray(j_decode(jc, jnp.asarray(sym.reshape(B, -1)), N_BYTES * 8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert ("spiral_update" if spiral else "quantized_update") in _build.LAUNCHES


def test_card_route_keeps_the_loop_at_k10(card_route, monkeypatch):
    """At K >= 10 the card's route is the plain loop: no launch."""
    code = ported(K10)
    loops = []
    plain = pq._u8_update
    monkeypatch.setattr(pq, "_u8_update", lambda *a: loops.append(1) or plain(*a))
    sym = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 20, 2), dtype=np.uint8))
    pq.quantized_update(code, pq.init_metrics_u8(code, 2, device="cpu"), sym)
    pq.spiral_update(code, pq.init_metrics_u8(code, 2, device="cpu"), sym)
    assert card_route == [] and loops == [1, 1]


def test_cpu_route_is_the_plain_version(monkeypatch):
    """On the CPU the update is ``_u8_update``: the launcher is never
    reached."""
    def refuse(*a):
        raise AssertionError("the launcher was reached on the CPU")

    monkeypatch.setattr(u8, "launch_u8", refuse)
    code = ported(J.VITERBI29)
    sym = _stream(code, 127)
    for spiral, update in ((False, pq.quantized_update), (True, pq.spiral_update)):
        m, _ = update(code, pq.init_metrics_u8(code, B, device="cpu"), torch.from_numpy(sym))
        want, _ = pq._u8_update(code, pq.init_metrics_u8(code, B, device="cpu"),
                                torch.from_numpy(sym), spiral)
        assert torch.equal(m, want)


def test_threshold_is_read_at_call_time(card_route, monkeypatch):
    """``SPIRAL_RENORM_THRESHOLD`` as it reads at the call reaches the
    launcher (a lifted threshold, as ``test_spiral_renormalisation_fired``
    sets it, too), and the results follow it."""
    code = ported(J.VITERBI27)
    sym = torch.from_numpy(_stream(code, 255))
    m0 = pq.init_metrics_u8(code, B, device="cpu")
    outs = []
    for thr in (180, 255):
        monkeypatch.setattr(pq, "SPIRAL_RENORM_THRESHOLD", thr)
        m, _ = pq.spiral_update(code, m0, sym)
        assert card_route[-1][1] == thr
        assert torch.equal(m, pq._u8_update(code, m0, sym, True)[0])
        outs.append(m)
    assert not torch.equal(*outs)


def test_launcher_refuses_what_the_kernel_does_not_take():
    code = ported(J.VITERBI27)
    m = torch.zeros((2, 64), dtype=torch.uint8)
    sym = torch.zeros((2, 5, 2), dtype=torch.uint8)
    tables = tables_of(code, False)
    with pytest.raises(ValueError, match="^quantized_update: metrics must lie on"):
        u8.launch_u8(code, tables, m, sym, 32, 210, False)
    with pytest.raises(ValueError, match="^spiral_update: metrics must lie on"):
        u8.launch_u8(code, tables_of(code, True), m, sym, 32, 210, True)
    with pytest.raises(ValueError, match="K = 2..9"):
        u8.launch_u8(ported(K10), tables, m, sym, 32, 210, False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B_,T", [(1, 45), (33, 301), (130, 64)])
@pytest.mark.parametrize("jc,family", [(J.VITERBI27, "ka9q"), (J.VITERBI27, "spiral"),
                                       (J.VITERBI29, "ka9q"), (J.VITERBI29, "spiral"),
                                       (INVERTED[0], "spiral"), (CODES[3], "ka9q"),
                                       (CODES[1], "spiral")],
                         ids=lambda x: x if isinstance(x, str) else x.name)
def test_cuda_kernel_equals_plain_version(cuda_device, jc, family, B_, T, monkeypatch):
    """Random entry metrics and an all-noise stream: metrics and words equal
    ``_u8_update``'s on the card, one launch an update; SPIRAL's
    renormalisation fired (its threshold out of reach changes the metrics)."""
    code, spiral = ported(jc), FAMILIES[family]
    rng = np.random.default_rng(B_ * T)
    m0 = torch.from_numpy(rng.integers(0, 256, (B_, code.num_states), dtype=np.uint8)).cuda()
    sym = torch.from_numpy(rng.integers(0, 256, (B_, T, 2), dtype=np.uint8)).cuda()
    update = pq.spiral_update if spiral else pq.quantized_update
    counter = "spiral_update" if spiral else "quantized_update"
    n = _build.LAUNCHES[counter]
    m, w = update(code, m0, sym)
    assert _build.LAUNCHES[counter] == n + 1
    m_r, w_r = pq._u8_update(code, m0, sym, spiral)
    assert torch.equal(m, m_r) and torch.equal(w, w_r[:T].permute(2, 0, 1))
    if spiral:
        monkeypatch.setattr(pq, "SPIRAL_RENORM_THRESHOLD", 255)
        assert not torch.equal(update(code, m0, sym)[0], m)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cuda_decode_equals_cpu(cuda_device, family):
    code = ported(J.VITERBI29)
    sym = _stream(code, 127).reshape(B, -1)
    decode = pq.decode_symbols_spiral if FAMILIES[family] else pq.decode_symbols_ka9q
    assert torch.equal(decode(code, sym, N_BYTES * 8).cpu(),
                       decode(code, sym, N_BYTES * 8, device="cpu"))
