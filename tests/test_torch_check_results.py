"""The port's claim-grade gate (``harness/check_results.py``) and merge
(``harness/merge_bench.py``) against the JAX package's repo-root tools
(``tools/check_results.py``, ``tools/merge_bench.py``), on the CPU.

The same hand-made rows go through both gates, in each one's family names
(``tpu_pallas*`` / ``tpu_jnp*`` / ``cpu_native*`` against ``gpu_cuda*`` /
``gpu_torch*`` / ``cpu_native*``), with the HBM roofline pinned to one figure
for both: ``check``, ``vs_baseline_rows`` and ``losing_cells`` agree once the
names are mapped, one case a rule.  Then the gate runs on a tiny
``harness/runner.py --device cpu`` JSON (one short frame a code), and the
merge on two partial files.  Tolerance: exact equality (the same floats
through the same arithmetic)."""

import json
import re
import subprocess
import sys
from fractions import Fraction

import pytest

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu_torch.harness import check_results as pcr
from ka9q_viterbi_comparison_tpu_torch.harness import merge_bench as pmb
from ka9q_viterbi_comparison_tpu_torch.harness import runner

from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
HBM = 3.35e12
TO_PORT = {"tpu_pallas": "gpu_cuda", "tpu_jnp": "gpu_torch", "cpu_native": "cpu_native"}
CODES = {(c.K, c.R): c for c in P.STANDARD_CODES}


@pytest.fixture
def jcr(monkeypatch):
    """The JAX package's gate, both gates' roofline pinned to one figure."""
    sys.path.insert(0, str(REPO / "tools"))
    import check_results

    monkeypatch.setattr(check_results, "HBM_BYTES_PER_S", HBM)
    monkeypatch.setattr(pcr, "HBM_BYTES_PER_S", HBM)
    return check_results


def to_port(text: str) -> str:
    """A JAX-side name or message in the port's family names."""
    for j, p in (("tpu_pallas", "gpu_cuda"), ("tpu_jnp", "gpu_torch"),
                 ("a pallas cell", "a cuda cell")):
        text = text.replace(j, p)
    return text


def row(name: str, K: int, R: int, update_rate: float, cb_rate: float, n: int = 8,
        jitter: float = 0.02, ber: float = 0.0) -> dict:
    """A reference-schema row of ``n`` samples around the given mean rates
    (update symbols/s, chainback bits/s) at the config's bench frame size."""
    code = CODES[(K, R)]
    B = 8
    nbytes = B * P.BENCH_FRAME_BYTES[code.name]
    syms = B * code.total_symbols(P.BENCH_FRAME_BYTES[code.name])
    wiggle = [1 + jitter * ((-1) ** i) for i in range(n)]
    return {
        "name": name, "K": K, "R": R, "poly": list(code.polys),
        "total_input_bytes": nbytes, "total_transmit_bits": B * code.transmit_bits(
            P.BENCH_FRAME_BYTES[code.name]),
        "total_output_symbols": syms, "sampling_time": 1.0, "minimum_samples": n,
        "total_samples": n, "init_ns": [2000] * n,
        "update_ns": [int(syms / update_rate * 1e9 * w) for w in wiggle],
        "chainback_ns": [int(nbytes * 8 / cb_rate * 1e9 * w) for w in wiggle],
        "total_bits": nbytes * 8, "total_bit_errors": int(ber * nbytes * 8),
        "bit_error_rate": ber,
    }


def matrix(family_names=("tpu_pallas", "tpu_jnp", "cpu_native")) -> list[dict]:
    """A claim-grade matrix in the JAX names: every pallas cell at twice its
    best reference column, every jnp cell at 0.8 of it (losing, allowed),
    the host rows slow."""
    fast, slow, host = family_names
    rows = []
    for (K, R) in CODES:
        up = max(pcr.BASELINE_UPDATE[(K, R)].values())
        cb = max(pcr.BASELINE_CHAINBACK[(K, R)].values())
        cb = min(cb, 1e9)  # K=7 and K=9 equal: the K9/K7 rule holds
        for tag in ("", "_s16", "_ob"):
            if tag == "_ob" and "ka9q" not in pcr.BASELINE_UPDATE[(K, R)]:
                continue
            rows.append(row(fast + tag, K, R, 2 * up, 2 * cb))
            rows.append(row(slow + tag, K, R, 0.8 * up, 0.8 * cb))
            rows.append(row(host + tag, K, R, 1e-3 * up, 1e-3 * cb))
    return rows


def renamed(rows: list[dict]) -> list[dict]:
    out = []
    for r in rows:
        r = dict(r)
        for j, p in TO_PORT.items():
            if r["name"].startswith(j):
                r["name"] = p + r["name"][len(j):]
        out.append(r)
    return out


def both(jcr, tmp_path, rows):
    """Problems of the JAX gate (mapped to the port's names) and of the
    port's gate on the same rows in each one's names, sorted."""
    jpath, ppath = tmp_path / "j.json", tmp_path / "p.json"
    jpath.write_text(json.dumps(rows))
    ppath.write_text(json.dumps(renamed(rows)))
    return (sorted(to_port(x) for x in jcr.check(str(jpath))),
            sorted(pcr.check(str(ppath))))


def test_thresholds_and_baseline_are_the_jax_gates(jcr):
    assert (pcr.FLOOR_NS, pcr.MAX_REL_STD) == (jcr.FLOOR_NS, jcr.MAX_REL_STD)
    assert pcr.BASELINE_UPDATE == jcr.BASELINE_UPDATE
    assert pcr.BASELINE_CHAINBACK == jcr.BASELINE_CHAINBACK
    assert pcr.COLUMNS == jcr.COLUMNS
    from ka9q_viterbi_comparison_tpu.ops.radix_planes import W_WALK

    assert pcr.W_WALK == W_WALK


def test_roofline_is_the_cards_figure():
    from ka9q_viterbi_comparison_tpu_torch.utils.chipinfo import chip_info

    assert pcr.HBM_BYTES_PER_S == chip_info().hbm_bytes_per_s


def test_claim_grade_matrix_agrees(jcr, tmp_path):
    rows = matrix()
    jp, pp = both(jcr, tmp_path, rows)
    assert jp == pp == []
    jvs = [dict(e, name=to_port(e["name"])) for e in jcr.vs_baseline_rows(rows)]
    assert pcr.vs_baseline_rows(renamed(rows)) == jvs
    assert len(jvs) == 32 and all("update" in e and "chainback" in e for e in jvs)
    losing = pcr.losing_cells(renamed(rows))
    assert losing == [to_port(c) for c in jcr.losing_cells(rows)]
    assert len(losing) >= 12 and all(c.startswith("gpu_torch") for c in losing)


def _edit(rows, name, K, R, **kw):
    for r in rows:
        if (r["name"], r["K"], r["R"]) == (name, K, R):
            r.update(kw)
            return r
    raise KeyError((name, K, R))


@pytest.mark.parametrize("case", ["floored", "zero", "jitter", "errors", "roofline", "k9_over_k7",
                                  "cell_loses"])
def test_each_rule_agrees(jcr, tmp_path, case):
    """One violation a case: the port's gate names it, as the JAX gate does."""
    rows = matrix()
    r = _edit(rows, "tpu_pallas", 7, 2)
    if case == "floored":
        r["update_ns"] = r["update_ns"][:-1] + [900]
        want = "gpu_cuda K=7 R=2: 1/8 update samples on the 1000 ns floor"
    elif case == "zero":
        r["chainback_ns"] = r["chainback_ns"][:-1] + [0]
        want = "gpu_cuda K=7 R=2: 1/8 chainback samples on the 1000 ns floor"
    elif case == "jitter":
        r["update_ns"] = [x * (1 + 0.3 * (-1) ** i) for i, x in enumerate(r["update_ns"])]
        want = "gpu_cuda K=7 R=2: update std 32% > 15% of mean"
    elif case == "errors":
        _edit(rows, "cpu_native_s16", 9, 4, bit_error_rate=1e-3)
        want = "cpu_native_s16 K=9 R=4: nonzero BER 0.001"
    elif case == "roofline":
        # 512 K=7 frames (4.2 Mbit) in 5 us: 839 Gbit/s x 8 B/bit
        r.update(total_input_bytes=512 * 1024, chainback_ns=[5000] * 8)
        want = "gpu_cuda K=7 R=2: chainback 839 Gbit/s x 8 B/bit exceeds the 3350 GB/s"
    elif case == "k9_over_k7":
        r9 = _edit(rows, "tpu_jnp", 9, 2)
        r9["chainback_ns"] = [x // 3 for x in r9["chainback_ns"]]
        want = "gpu_torch: K=9 chainback"
    else:
        r15 = _edit(rows, "tpu_pallas_ob", 15, 6)
        r15["update_ns"] = [x * 4 for x in r15["update_ns"]]
        want = "claim violation: gpu_cuda_ob K=15 R=6 update (0.89x the reference ka9q column)"
    if case == "zero":
        # The JAX gate divides by the zero sample; the port's refuses it.
        with pytest.raises(ZeroDivisionError):
            both(jcr, tmp_path, rows)
        pp = pcr.check_rows(renamed(rows))
        assert pp[0] == want and all("K=7 R=2" in x for x in pp), pp
        return
    jp, pp = both(jcr, tmp_path, rows)
    assert pp == jp
    assert any(want in x for x in pp), pp
    if case == "cell_loses":
        # beside it a gpu_torch cell that loses: listed, not a failure
        losing = pcr.losing_cells(renamed(rows))
        assert any(c.startswith("gpu_torch K=15 R=6 update") for c in losing)
        assert not any("claim violation: gpu_torch" in x for x in pp)
        assert len(pp) == 1


def _rate(r: dict, bits_per_s: float) -> None:
    """Set a row's chainback samples to ``bits_per_s``."""
    r["chainback_ns"] = [int(r["total_input_bytes"] * 8 / bits_per_s * 1e9)] * 8


@pytest.mark.parametrize("case", ["cassini_cuda_measured", "cassini_cuda_beyond", "cassini_torch",
                                  "k9_cuda_beyond", "k24_cuda_beyond"])
def test_roofline_counts_the_port_walks_bytes(jcr, tmp_path, case):
    """Rule 3 counts the bytes a decoded bit of the walk the row's family
    runs: 24.8 B at K = 10-15 and 0.5 B above K=15 for ``gpu_cuda`` rows,
    the JAX gate's count (2048 B at K=15, 32 B at K=9, 1 B at K=24) for
    ``gpu_torch`` rows and for ``gpu_cuda`` at K <= 9.  A Cassini ``gpu_cuda``
    traceback at 1.67 Gbit/s (the card's reading) passes the port's gate,
    which the JAX gate refuses; at 140 Gbit/s, beyond the 135 Gbit/s line of
    24.8 B a bit, the port's gate refuses it too."""
    rows = matrix()
    if case.startswith("cassini"):
        r = _edit(rows, "tpu_jnp" if case == "cassini_torch" else "tpu_pallas", 15, 6,
                  total_input_bytes=1 << 24)  # above the 1 us floor at 140 Gbit/s
        _rate(r, 140e9 if case == "cassini_cuda_beyond" else 1.67e9)
    elif case == "k9_cuda_beyond":  # beyond 3.35 TB/s / 32 B = 104.7 Gbit/s
        r = _edit(rows, "tpu_pallas", 9, 2, total_input_bytes=1 << 24)
        _rate(r, 110e9)
    else:  # beyond 3.35 TB/s / 0.5 B = 6.7 Tbit/s
        r = _edit(rows, "tpu_pallas", 24, 2, total_input_bytes=1 << 24)
        _rate(r, 7e12)
    jp, pp = both(jcr, tmp_path, rows)
    roof = "exceeds the 3350 GB/s HBM roofline"
    if case == "cassini_cuda_measured":
        assert pp == []
        assert jp == [f"gpu_cuda K=15 R=6: chainback 1.67 Gbit/s x 2048 B/bit {roof}"]
    elif case == "cassini_cuda_beyond":
        assert pp == [f"gpu_cuda K=15 R=6: chainback 140 Gbit/s x 24.8 B/bit {roof}"]
        assert jp == [f"gpu_cuda K=15 R=6: chainback 140 Gbit/s x 2048 B/bit {roof}"]
    elif case == "cassini_torch":
        assert pp == jp == [f"gpu_torch K=15 R=6: chainback 1.67 Gbit/s x 2048 B/bit {roof}"]
    elif case == "k9_cuda_beyond":
        assert pp == jp  # the K=9 over K=7 rule fires beside it in both
        assert f"gpu_cuda K=9 R=2: chainback 110 Gbit/s x 32 B/bit {roof}" in pp
    else:
        assert pp == [f"gpu_cuda K=24 R=2: chainback 7e+03 Gbit/s x 0.5 B/bit {roof}"]
        assert jp == [f"gpu_cuda K=24 R=2: chainback 7e+03 Gbit/s x 1.0 B/bit {roof}"]


def _source(name: str) -> str:
    return (REPO / "ka9q_viterbi_comparison_tpu_torch" / "csrc" / name).read_text()


def test_walk_byte_constants_are_the_kernels():
    """Rule 3's named constants are the CUDA walks' own, and the count they
    give never falls below what a frame's walk fetches.

    ``viterbi_small.cu``: ``kCbDepth`` steps a round, lane L's candidate
    d = log2(L + 1) steps back fetched where d < the round's steps (31 lanes
    a round of five), ``launch_chainback`` staging W = 1, 2, 4, 8 words a
    step and walking wider steps on ``chainback_kernel<ROT, 0>``.
    ``viterbi_walk.cu``: the widest window is 8 steps, one f8 word holding
    an 8-bit field.  Then, mirrored in Python: a frame of T steps takes
    31 floor(T/5) + 2^(T mod 5) - 1 fetches, at least 31/5 a decoded bit
    for every T >= 8 bytes + 4; the f8 plan fetches at least one word a
    decoded bit's eighth; the canonical words' 31 candidates of a round lie
    in 31 distinct words at every K = 10-15, and the rotated form's in
    fewer (137/7 a round on average at K=15, over its 14 rotations)."""
    small, walk = _source("viterbi_small.cu"), _source("viterbi_walk.cu")
    assert int(re.search(r"constexpr int kCbDepth = (\d+);", small)[1]) == pcr.CB_DEPTH
    assert "const int d = 31 - __clz(lane + 1);" in small
    assert "const int n = min(kCbDepth, t + 1);" in small and "if (d < n) {" in small
    assert pcr.CB_ROUND_FETCHES == sum(1 << d for d in range(pcr.CB_DEPTH)) == 31
    launch = small[small.index("cudaError_t launch_chainback("):]
    launch = launch[:launch.index("return cudaGetLastError();")]
    staged = [int(w) for w in re.findall(r"W == (\d+)\)\s*\n\s*chainback_kernel<ROT, \1>", launch)]
    assert staged == [1, 2, 4, 8] and max(staged) == pcr.CB_STAGED_MAX_WORDS
    assert re.search(r"else\s*\n\s*chainback_kernel<ROT, 0>", launch)
    assert "const int W = K >= 7 ? 1 << (K - 6) : 1;" in launch
    assert int(re.search(r"maxw != 4 && maxw != (\d+)", walk)[1]) == pcr.PLANE_WINDOW
    assert "if (w == 8) {" in walk and "F = (word >> ((s & 3) * 8)) & 0xFFu;" in walk

    per_bit = {K: pcr.walk_bytes_per_bit("gpu_cuda", K) for K in range(2, 25)}
    assert [per_bit[K] for K in (7, 9, 10, 15, 16, 24)] == [8, 32, 24.8, 24.8, 0.5, 0.5]
    for nbytes in range(1, 64):
        for T in range(8 * nbytes + 4, 8 * nbytes + 24):
            fetches, t = 0, T - 1
            while t >= 0:  # chainback_kernel's rounds
                n = min(pcr.CB_DEPTH, t + 1)
                fetches += sum(1 for lane in range(32) if (lane + 1).bit_length() - 1 < n)
                t -= n
            assert fetches == 31 * (T // 5) + 2 ** (T % 5) - 1
            assert fetches * pcr.WORD_BYTES >= per_bit[15] * 8 * nbytes
    from ka9q_viterbi_comparison_tpu_torch.ops.radix_planes import plane_plan

    for nbytes in (1, 8, 64):
        T, anchor = 8 * nbytes + 23, 23
        fetches = sum(1 if w in (8, 4, 1) else 2 for _, w in plane_plan(T, anchor, 8))
        assert fetches * pcr.WORD_BYTES >= per_bit[24] * 8 * nbytes

    def distinct_words(K: int, rot: bool) -> Fraction:
        """Distinct (step, word) pairs a round's 31 lanes fetch, averaged
        over the rotations and 16 positions (``walk_back`` in Python)."""
        nrot = K - 1
        mask = (1 << nrot) - 1

        def rotr(x, r):
            return ((x >> r) | (x << (nrot - r))) & mask

        total = count = 0
        for jj in range(nrot if rot else 1):
            for pos in range(0, 1 << nrot, (1 << nrot) // 16):
                words = set()
                for lane in range(31):
                    d = (lane + 1).bit_length() - 1
                    cb = int(format((lane + 1) ^ (1 << d), f"0{d}b")[::-1], 2) if d else 0
                    if rot:
                        cand = rotr((rotr(pos, jj) & ~((1 << d) - 1)) | cb, nrot - jj if jj else 0)
                    else:
                        cand = (pos >> d) | (cb << (K - 1 - d))
                    words.add((d, cand >> 5))
                total, count = total + len(words), count + 1
        return Fraction(total, count)

    assert all(distinct_words(K, False) == pcr.CB_ROUND_FETCHES for K in range(10, 16))
    assert distinct_words(15, True) == Fraction(137, 7)


def test_init_at_or_below_zero_is_refused(jcr, tmp_path):
    """The port's one rule more: a non-positive init sample is a misfired
    chain (the JAX gate leaves init to the floor rule, which init may sit
    under)."""
    rows = matrix()
    _edit(rows, "tpu_jnp", 24, 2, init_ns=[2000] * 7 + [0])
    jp, pp = both(jcr, tmp_path, rows)
    assert jp == []
    assert pp == ["gpu_torch K=24 R=2: 1/8 init samples at or below 0 ns"]


def test_main_exit_codes(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(pcr, "HBM_BYTES_PER_S", HBM)
    good = tmp_path / "good.json"
    good.write_text(json.dumps(renamed(matrix())))
    pcr.main([str(good)])
    assert capsys.readouterr().out.startswith("OK ")
    rows = renamed(matrix())
    _edit(rows, "gpu_cuda", 24, 2, bit_error_rate=0.5)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(rows))
    with pytest.raises(SystemExit) as e:
        pcr.main([str(bad)])
    assert e.value.code == 1
    assert "FAIL gpu_cuda K=24 R=2: nonzero BER 0.5" in capsys.readouterr().out


def test_gate_on_a_cpu_runner_json(jcr, tmp_path):
    """The runner on the CPU, one 1-byte frame a code (K <= 15: ICE's
    2^23 states take minutes a step on the host), two samples a row: the
    rows carry no bit errors and no floored sample, and both gates find the
    same problems (std and claim rules, at CPU speeds) once renamed."""
    out = tmp_path / "cpu.json"
    codes = [c.name for c in P.STANDARD_CODES if c.K <= 15]
    runner.main(["-t", "0", "-n", "2", "--batch", "1", "--frame-bytes", "1", "--device", "cpu",
                 "--backends", "cuda", "torch", "--codes", *codes, "-o", str(out)])
    rows = json.loads(out.read_text())
    assert len(rows) == 2 * 13 and {r["name"].split("_")[0] for r in rows} == {"gpu"}
    problems = pcr.check(str(out))
    assert not any("BER" in x or "floor" in x or "roofline" in x or "init" in x
                   for x in problems), problems
    jrows = []
    for r in rows:
        r = dict(r)
        r["name"] = r["name"].replace("gpu_cuda", "tpu_pallas").replace("gpu_torch", "tpu_jnp")
        jrows.append(r)
    jpath = tmp_path / "j.json"
    jpath.write_text(json.dumps(jrows))
    assert sorted(problems) == sorted(to_port(x) for x in jcr.check(str(jpath)))
    covered = [e for e in pcr.vs_baseline_rows(rows) if e["name"].startswith("gpu_cuda")]
    assert len(covered) == 13 and all("update" in e and "chainback" in e for e in covered)


def test_merge_two_partial_files(tmp_path):
    """Later files win on ``(name, K, R)``; a row cut mid-write is dropped;
    the output is one object a line in matrix order -- and the JAX tool
    gives the same file once the names are mapped."""
    rows = renamed(matrix())
    k7 = [r for r in rows if r["K"] == 7 and r["R"] == 2]
    k24 = [r for r in rows if r["K"] == 24]
    p1 = tmp_path / "p1.json"
    p1.write_text("[\n" + ",\n".join(json.dumps(r) for r in k24 + k7) + "\n]\n")
    newer = dict(k7[0], update_ns=[7] * 8)
    cut = json.dumps(k24[1])[:40]
    p2 = tmp_path / "p2.json"
    p2.write_text("[\n" + json.dumps(newer) + ",\n" + cut)
    out = tmp_path / "merged.json"
    merged = pmb.merge(str(out), [str(p1), str(p2)])
    assert len(merged) == len(k7) + len(k24)
    assert [(r["K"], r["name"]) for r in merged][:3] == [(7, "gpu_cuda"), (7, "gpu_torch"),
                                                         (7, "cpu_native")]
    assert merged[0]["update_ns"] == [7] * 8 and merged[-1]["K"] == 24
    text = out.read_text()
    assert text.startswith("[\n") and text.endswith("\n]\n")
    assert len(text.splitlines()) == len(merged) + 2
    assert json.loads(text) == merged

    # The JAX tool on the same parts in its names.
    def back(text):
        for j, p in (("tpu_pallas", "gpu_cuda"), ("tpu_jnp", "gpu_torch")):
            text = text.replace(f'"{p}', f'"{j}')
        return text

    j1, j2, jout = tmp_path / "j1.json", tmp_path / "j2.json", tmp_path / "jm.json"
    j1.write_text(back(p1.read_text()))
    j2.write_text(back(p2.read_text()))
    subprocess.run([sys.executable, str(REPO / "tools" / "merge_bench.py"), str(jout), str(j1),
                    str(j2)], check=True, capture_output=True, timeout=60)
    assert to_port(jout.read_text()) == text
