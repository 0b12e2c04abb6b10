"""The staged traceback's segments (K <= 9) against the serial walk.

``chainback_kernel<ROT, WT>`` walks a frame's time as ``kernels.walk_plan``'s
segments: each from a guessed state D steps above its top; then, from the top
down, again from the exact bottom of the segment above wherever its guess met
another position there, a chunk at a time until a chunk's word comes out as it
was.  ``replay_segments`` is that walk in plain PyTorch, step for step, on the
plan's own ``(n, L, D)`` or on one given; it returns the outputs
in every form and the count of segments walked again, which the kernel adds
to ``kernels.rewalk_stats`` (the card's tests in ``test_torch_walk_forms.py``
hold the two counts equal).  Here the replay is held bit-identical to
``kernels.walk_ref`` (the serial walk, itself held to the JAX package by
``test_torch_walk_forms.py``) at K = 3..9, both packings, every output and
end-state form, start steps, output cuts and rotation phases; at lengths on
the segments' edges; on random words, which make the guesses fail and force
runs of re-walks, and on noisy encoded frames.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from ka9q_viterbi_comparison_tpu_torch import VITERBI27, VITERBI29, soft8_spec
from ka9q_viterbi_comparison_tpu_torch.configs import CodeSpec
from ka9q_viterbi_comparison_tpu_torch.ops import acs
from ka9q_viterbi_comparison_tpu_torch.ops.channel import awgn_symbols
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import inplace as pip, kernels as pk

POLYS = {3: (0o7, 0o5), 4: (0o17, 0o15), 5: (0o23, 0o35), 6: (0o53, 0o75), 7: (0o171, 0o133),
         8: (0o247, 0o371), 9: (0o561, 0o753)}


def code_k(K):
    return CodeSpec(f"k{K}r2", K, 2, POLYS[K])


def _decide(code, words, b, state, t, rotated, p0):
    """The walk's decision at step ``t`` from ``state`` (lanes of frames
    ``b``), as ``chainback.walk`` reads it."""
    nrot, mask = code.K - 1, code.num_states - 1
    pos = state
    if rotated:
        rho = (t + 1 + p0) % nrot
        pos = ((state >> rho) | (state << (nrot - rho))) & mask
    word = words[t, pos >> 5, b]
    return (word >> (pos & 31)) & 1


def replay_segments(code, dec_words, endstate, t_real, rotated=False, p0=0, form="words", lo=0,
                    hi=None, start=None, metrics=None, metrics_phase=0, plan=None):
    """The segmented walk as the kernel makes it, in plain PyTorch:
    ``(outputs in ``form``, segments walked again)``."""
    Tp, W, B = dec_words.shape
    hi = t_real if hi is None else hi
    n, L, D = pk.walk_plan(code.K, B, t_real) if plan is None else plan
    assert L % 32 == 0 and (n - 1) * L < t_real <= n * L
    K = code.K
    if metrics is not None:
        end = pk.argmin_states(code, metrics, metrics_phase)
    else:
        end = pk._end_states(code, endstate, B, dec_words.device).reshape(B)
    words = dec_words[:t_real].to(torch.int64) & 0xFFFFFFFF
    if start is not None:
        first = start.to(torch.int64).reshape(B)
        live = torch.arange(t_real)[:, None] < first
        words = torch.where(live[:, None, :], words, torch.zeros((), dtype=torch.int64))
        end = torch.where(first < t_real, torch.zeros_like(end), end)
    end = end.to(torch.int64)
    seg = torch.arange(n)
    lo_k = seg * L
    hi_k = torch.clamp(lo_k + L, max=t_real)
    from_k = torch.where(seg == n - 1, t_real, torch.clamp(hi_k + D, max=t_real))
    b = torch.arange(B)[:, None].expand(B, n)
    ks = torch.zeros((B, t_real), dtype=torch.int64)

    # Phase 1: every segment from its guess (the end state where it starts at t_real).
    state = torch.where(from_k == t_real, end[:, None], torch.zeros((), dtype=torch.int64))
    q = state.clone()
    for i in range(int((from_k - lo_k).max())):
        t = from_k - 1 - i
        on = (t >= lo_k).expand(B, n)
        tt = t.clamp(min=0).expand(B, n)
        k = _decide(code, words, b, state, tt, rotated, p0)
        state = torch.where(on, (state >> 1) | (k << (K - 2)), state)
        keep = on & (tt < hi_k)
        ks[b[keep], tt[keep]] = k[keep]
        q = torch.where(on & (tt == hi_k), state, q)
    e = state

    # Phase 2: a frame at a time from the top down, the segments whose guess
    # met another position at their top walked again from the exact bottom
    # above, a chunk at a time until a chunk's word comes out as it was.
    rewalked = 0
    entry = e[:, n - 1]
    for kk in range(n - 2, -1, -1):
        redo = q[:, kk] != entry
        rewalked += int(redo.sum())
        rb = redo.nonzero(as_tuple=True)[0]
        st = entry[rb]
        going = torch.ones_like(rb, dtype=torch.bool)
        for c0 in range(int(hi_k[kk]) - 32, int(lo_k[kk]) - 1, -32):
            got = torch.zeros((len(rb), 32), dtype=torch.int64)
            for u in range(31, -1, -1):
                k = _decide(code, words, rb, st, torch.full_like(rb, c0 + u), rotated, p0)
                st = torch.where(going, (st >> 1) | (k << (K - 2)), st)
                got[:, u] = k
            same = (ks[rb, c0:c0 + 32] == got).all(dim=1)
            write = going & ~same
            ks[rb[write], c0:c0 + 32] = got[write]
            going &= ~same
        entry = e[:, kk].clone()
        entry[rb[going]] = st[going]
    return pk.walk_outputs(ks, form, lo, hi, Tp), rewalked


def random_words(code, T, B, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, size=(T, code.decision_words, B))
                            .astype(np.int32))


def noisy_words(code, B, nbytes, rotated, seed, ebn0=3.0):
    """Decision words of ``B`` frames of ``nbytes`` random bytes, encoded,
    through AWGN at ``ebn0`` dB and the plain ACS (state order, or position
    order from phase 0): ``(words [T, W, B], data bits)``."""
    numeric = soft8_spec(code.R)
    data = np.random.default_rng(seed).integers(0, 256, size=(B, nbytes), dtype=np.uint8)
    g = torch.Generator().manual_seed(seed)
    sym = awgn_symbols(code, numeric, data, ebn0, generator=g, device="cpu")
    sym = sym.reshape(B, -1, code.R).permute(1, 2, 0)
    T = sym.shape[0]
    m0 = acs.init_metrics(code, numeric, B).T.contiguous()
    update = pip.acs_update_inplace_ref if rotated else pk.acs_update_tb_ref
    _, dec = update(code, numeric, m0, sym, T)
    return dec, np.unpackbits(data, axis=1)


def form_calls(code, B, t_real, rotated, p0=0, seed=0, cuts=True):
    """``(endstate, form, keywords)`` of walks in every end-state form and
    from a start step (the words form), then (``cuts``) in the bits and
    bytes forms and cuts from the argmin; CPU tensors."""
    S = code.num_states
    rng = np.random.default_rng(seed)
    m = torch.from_numpy(rng.integers(0, 4, size=(S, B)).astype(np.int32))
    argmin = dict(metrics=m, metrics_phase=(p0 + t_real) % (code.K - 1) if rotated else 0)
    start = torch.from_numpy(rng.integers(0, t_real + 30, size=B).astype(np.int32))
    calls = [(int(rng.integers(0, S)), "words", {}),
             (torch.from_numpy(rng.integers(0, S, size=B).astype(np.int32)), "words", {}),
             (torch.tensor(min(S - 1, 200), dtype=torch.uint8), "words", {}),
             (None, "words", argmin),
             (int(rng.integers(0, S)), "words", dict(start=start))]
    if cuts:
        lo, a = min(code.K - 1, t_real), min(5, t_real)
        calls += [(None, form, dict(argmin, lo=x, hi=y)) for form, x, y in
                  [("bits", 0, t_real), ("bits", a, max(a, t_real - 2)),
                   ("bytes", lo, lo + (t_real - lo) // 8 * 8)]]
    return calls


def check_forms(code, dec, t_real, rotated, p0=0, plan=None, seed=0, cuts=True):
    """The replay against the serial walk in each of ``form_calls``;
    returns each call's re-walks."""
    counts = []
    for end, form, kw in form_calls(code, dec.shape[2], t_real, rotated, p0, seed, cuts):
        got, n = replay_segments(code, dec, end, t_real, rotated, p0, form, plan=plan, **kw)
        want = pk.walk_ref(code, dec, end, t_real, rotated, p0, form, **kw)
        assert torch.equal(got, want), (t_real, plan, form, sorted(kw))
        counts.append(n)
    return counts


# -- the plan -------------------------------------------------------------------------


@pytest.mark.parametrize("K", [3, 5, 7, 9])
def test_plan_cuts_the_frame_into_whole_chunks(K):
    """Every plan: segments of a multiple of 32 steps that cover [0, T), the
    last one ending at T, at most ``WALK_MAX_SEGMENTS``; an overlap of at
    least ten constraint lengths in whole chunks; more than one segment only
    where the batch alone does not fill the card and T > L + D."""
    for B in (1, 7, 9, 130, 512, 4096, pk.WALK_CHAINS - 1, pk.WALK_CHAINS, 10**5):
        for T in (1, 31, 32, 33, 95, 96, 97, 300, 1000, 4104, 8198, 8248, 65536, 10**6):
            n, L, D = pk.walk_plan(K, B, T)
            assert L % 32 == 0 and L >= 32 and D % 32 == 0 and 10 * (K - 1) <= D < 10 * (K - 1) + 32
            assert (n - 1) * L < T <= n * L and 1 <= n <= pk.WALK_MAX_SEGMENTS, (B, T)
            if n > 1:
                assert B < pk.WALK_CHAINS and T > L + D, (B, T)


@pytest.mark.parametrize("K", [3, 7, 9])
def test_plan_is_one_segment_where_the_batch_or_the_frame_says(K):
    """n = 1 (the serial walk, no overlap) where B alone reaches a warp of
    chains on every SM sub-partition, or where T <= L + D."""
    for T in (1, 32, 100, 8198, 10**6):
        assert pk.walk_plan(K, pk.WALK_CHAINS, T)[0] == 1
        assert pk.walk_plan(K, 2 * pk.WALK_CHAINS + 1, T)[0] == 1
    for B in (1, 9, 512):
        for T in range(1, 200):
            n, L, D = pk.walk_plan(K, B, T)
            assert n == 1 or T > L + D, (B, T)
            if T <= 32 + D:  # the shortest segment and its overlap
                assert n == 1, (B, T)


@pytest.mark.parametrize("T", [8198, 8248])
def test_plan_fills_the_card_at_the_cells_shape(T):
    """K=7, B=512 (the benchmark's frame and stream walks): B x n chains
    reach a warp on each of the 528 SM sub-partitions of an H100."""
    n, L, D = pk.walk_plan(7, 512, T)
    assert pk.WALK_CHAINS == 132 * 4 * 32
    assert 512 * n >= pk.WALK_CHAINS and (n, L, D) == (33, 256, 64)
    assert pk.walk_plan(9, 512, T)[2] == 96


# -- the replay against the serial walk -------------------------------------------------


@pytest.mark.parametrize("rotated", [False, True], ids=["tb", "inplace"])
@pytest.mark.parametrize("K", [3, 4, 5, 6, 7, 8, 9])
def test_replay_equals_the_serial_walk_on_random_words(K, rotated):
    """Random words (guesses that fail, runs of re-walks), B=9, T on the
    segments' edges with the plan's own (n, L, D) (L, D of T=8198 give the
    edges L-1, L+D, 2L+D+1) and with plans of short segments that make even
    T=33 two segments; every form, end kind, start step and a rotation
    phase."""
    code = code_k(K)
    B = 9
    _, L, D = pk.walk_plan(K, B, 8198)
    p0 = (K + 1) % (K - 1) if rotated else 0
    edges = [1, 31, 32, 33, L - 1, L + D, 2 * L + D + 1]
    dec = random_words(code, 2 * L + D + 40, B, seed=K)
    rewalked = 0
    for T in edges:
        check_forms(code, dec, T, rotated, p0, seed=T)
        if T > 32:
            for plan in ((-(-T // 32), 32, 32), (-(-T // 64), 64, 0)):
                if plan[0] <= pk.WALK_MAX_SEGMENTS:
                    rewalked += sum(check_forms(code, dec, T, rotated, p0, plan, seed=T,
                                                cuts=False))
    assert rewalked > 0


@pytest.mark.parametrize("rotated", [False, True], ids=["tb", "inplace"])
def test_replay_equals_the_serial_walk_for_one_frame(rotated):
    """B=1, K=7, random words: the plan's most segments (52 of 160 steps
    at T=8198), T on their edges, every form and end kind."""
    code = code_k(7)
    _, L, D = pk.walk_plan(7, 1, 8198)
    dec = random_words(code, 8198, 1, seed=11)
    for T in (1, 33, L - 1, L + D, 2 * L + D + 1, 8198):
        check_forms(code, dec, T, rotated, 2 if rotated else 0, seed=T)
    assert pk.walk_plan(7, 1, 8198) == (52, 160, 64)


@pytest.mark.parametrize("rotated", [False, True], ids=["tb", "inplace"])
def test_replay_equals_the_serial_walk_at_the_cells_shape(rotated):
    """K=7, B=512, T=8198 on random words, the plan (33, 256, 64): the
    words from an int and the bytes from the argmin, with the re-walk
    count of each (random words: most guesses fail)."""
    code = code_k(7)
    dec = random_words(code, 8198, 512, seed=5)
    p0 = 3 if rotated else 0
    calls = form_calls(code, 512, 8198, rotated, p0, seed=1)
    for end, form, kw in (calls[0], calls[-1]):
        got, n = replay_segments(code, dec, end, 8198, rotated, p0, form, **kw)
        assert torch.equal(got, pk.walk_ref(code, dec, end, 8198, rotated, p0, form, **kw))
        assert n > 512 * 33 // 4, (form, n)


@pytest.mark.parametrize("rotated", [False, True], ids=["tb", "inplace"])
@pytest.mark.parametrize("code", [VITERBI27, VITERBI29], ids=["k7", "k9"])
def test_replay_equals_the_serial_walk_on_noisy_frames(code, rotated):
    """512-byte frames through AWGN at 3 dB and the plain ACS, B=7: the
    guesses merge but for a few segments, and the replay is the serial
    walk in every form; a frame's bits from state 0 are its data but for
    the channel's errors."""
    dec, bits = noisy_words(code, 7, 512, rotated, seed=code.K)
    T = dec.shape[0]
    counts = check_forms(code, dec, T, rotated, seed=2)
    n, L, D = pk.walk_plan(code.K, 7, T)
    assert n > 1 and max(counts) <= 7 * (n - 1)
    got, _ = replay_segments(code, dec, 0, T, rotated, 0, "bits", code.K - 1, code.K - 1 + 4096)
    assert (got.numpy() != bits).mean() < 0.01


def test_replay_walks_again_where_a_guess_fails():
    """A hand-made case: with all-ones words at K=3 every decision is 1,
    whatever the state, so every chain is at state 3 two steps below its
    start.  With no overlap each lower segment's guess (0 at its top) is
    not the position there (3): each of the three lower segments of each of
    the two frames is walked again once, and stops at its first chunk, which
    agrees with the one phase 1 wrote.  With 32 steps of overlap every guess
    has met the exact path at its segment's top: nothing is walked again."""
    code = code_k(3)
    dec = torch.full((128, 1, 2), -1, dtype=torch.int32)
    got, n = replay_segments(code, dec, 0, 128, plan=(4, 32, 0))
    assert torch.equal(got, pk.walk_ref(code, dec, 0, 128)) and n == 2 * 3  # frames x lower segments
    got, n = replay_segments(code, dec, 0, 128, plan=(4, 32, 32))
    assert torch.equal(got, pk.walk_ref(code, dec, 0, 128)) and n == 0
