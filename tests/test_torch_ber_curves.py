"""The port's seven measured AWGN curves (``data/ber_torch_*.json``,
``docs/ber_torch_*.md``) against the JAX package's (``data/ber_*.json``).

Each curve was measured on the card by ``harness/ber_curve.py`` at the JAX
docs' own parameters and seed 0.  Here, on the CPU, from the checked-in
files: each doc is ``render`` of its JSON; each curve's command holds the
parameters of the JAX doc's and every point stopped at its error floor or its
bit budget; at every Eb/N0 where both curves have at least 30 frame errors,
their 99 % Wilson intervals on the FER overlap (frames are independent; bit
errors within a frame are not, so the BER interval is no test); the
coding-gain ordering of ``tests/test_ber.py`` holds on the port's curves; and
the CLI, at ``--device cpu --backend torch``, writes the points that
``harness.ber.ber_curve`` gives with the same arguments."""

import json
import math
import pathlib
import shlex

import pytest

import ka9q_viterbi_comparison_tpu_torch as P
from ka9q_viterbi_comparison_tpu_torch.harness import ber, ber_curve

REPO = pathlib.Path(__file__).resolve().parents[1]
DATA, DOCS = REPO / "data", REPO / "docs"

# name: (code, spec, Eb/N0 points, frame bytes, batch, min errors, max bits) -- the
# parameters of each JAX doc's command (docs/ber_viterbi*.md).
CURVES = {
    "viterbi27": ("viterbi27", "soft16", [0, 1, 2, 3, 4, 5], 128, 256, 300, 30_000_000),
    "viterbi27_hard8": ("viterbi27", "hard8", [0, 1, 2, 3, 4, 5, 6], 128, 256, 300, 30_000_000),
    "viterbi29": ("viterbi29", "soft16", [0, 1, 2, 3, 4, 5], 128, 256, 300, 30_000_000),
    "viterbi47": ("viterbi47", "soft16", [0, 1, 2, 3, 4, 5], 128, 256, 300, 30_000_000),
    "viterbi49": ("viterbi49", "soft16", [0, 1, 2, 3, 4, 5], 128, 256, 300, 30_000_000),
    "viterbi615": ("viterbi615", "soft16", [0, 0.5, 1, 1.5], 128, 128, 300, 12_000_000),
    "viterbi224": ("viterbi224", "soft8", [0, 0.5, 1, 1.5, 2], 8, 16, 300, 4_000_000),
}
MIN_FRAME_ERRORS = 30
Z99 = 2.5758293035489004  # two-sided 99 %


def port(name: str) -> dict:
    return json.loads((DATA / f"ber_torch_{name}.json").read_text())


def jax_points(name: str) -> dict[float, dict]:
    pts = json.loads((DATA / f"ber_{name}.json").read_text())
    return {float(p["ebn0_db"]): p for p in pts}


def wilson(k: int, n: int, z: float = Z99) -> tuple[float, float]:
    p = k / n
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return center - half, center + half


@pytest.mark.parametrize("name", CURVES)
def test_doc_is_render_of_its_json(name):
    rec = port(name)
    assert (DOCS / f"ber_torch_{name}.md").read_text() == ber_curve.render(**rec)
    assert rec["card"].startswith("NVIDIA H100") and rec["card"].endswith(" W")


@pytest.mark.parametrize("name", CURVES)
def test_curve_has_the_jax_docs_parameters(name):
    code, spec, ebn0, frame_bytes, batch, min_errors, max_bits = CURVES[name]
    rec = port(name)
    args = shlex.split(rec["command"])
    assert " ".join(args[:3]) == ber_curve.PROG
    opt = {}
    for a in args[3:]:
        if a.startswith("--"):
            key = a[2:]
            opt[key] = []
        else:
            opt[key].append(a)
    assert opt["code"] == [code] and opt["spec"] == [spec] and rec["code"] == code
    assert [float(x) for x in opt["ebn0"]] == ebn0
    assert opt["frame-bytes"] == [str(frame_bytes)] and opt["batch"] == [str(batch)]
    assert opt["min-errors"] == [str(min_errors)] and opt["max-bits"] == [str(max_bits)]
    assert opt.get("seed", ["0"]) == ["0"] and opt.get("backend", ["cuda"]) == ["cuda"]
    assert opt.get("device", ["cuda"]) == ["cuda"]
    assert opt["json"] == [f"data/ber_torch_{name}.json"]
    assert opt["doc"] == [f"docs/ber_torch_{name}.md"]
    assert [p["ebn0_db"] for p in rec["points"]] == ebn0
    for p in rec["points"]:
        assert p["bits"] == p["frames"] * frame_bytes * 8 and p["frames"] % batch == 0
        before = p["bits"] - batch * frame_bytes * 8  # the loop's test before the last batch
        assert p["errors"] >= min_errors or p["bits"] >= max_bits, p
        assert before < max_bits, p


@pytest.mark.parametrize("name", CURVES)
def test_fer_intervals_overlap_the_jax_curve(name):
    """99 % Wilson intervals on the FER, where both curves have at least 30
    frame errors.  The ICE curve of the JAX package has 15-27 frame errors a
    point, so no ICE point is compared."""
    theirs = jax_points(name)
    compared = []
    for p in port(name)["points"]:
        q = theirs.get(float(p["ebn0_db"]))
        if q is None or min(p["frame_errors"], q["frame_errors"]) < MIN_FRAME_ERRORS:
            continue
        lo, hi = wilson(p["frame_errors"], p["frames"])
        qlo, qhi = wilson(q["frame_errors"], q["frames"])
        assert lo <= qhi and qlo <= hi, (p["ebn0_db"], (lo, hi), (qlo, qhi))
        compared.append(p["ebn0_db"])
    want = [e for e, q in theirs.items() if q["frame_errors"] >= MIN_FRAME_ERRORS]
    assert set(compared) <= set(want)
    assert bool(compared) == (name != "viterbi224"), compared


def test_measured_waterfalls_coding_gain_ordering():
    """The ordering of ``tests/test_ber.py``'s test of the same name, on the
    port's curves: K=9 at least as good as K=7 at equal rate, r=1/4 at least
    as good as r=1/2 at equal K (from 2 dB, where both are resolved), and the
    Cassini code's best point beats the K=7 code's 2 dB point."""
    def bers(name):
        return {float(p["ebn0_db"]): float(p["ber"]) for p in port(name)["points"]
                if p["errors"] >= 50}

    v27, v29 = bers("viterbi27"), bers("viterbi29")
    v47, v49 = bers("viterbi47"), bers("viterbi49")
    v615 = bers("viterbi615")

    def worse(a, b, margin=1.2):
        shared = [e for e in sorted(set(a) & set(b)) if e >= 2.0 and a[e] > 1e-4]
        assert shared, "no shared resolved operating points"
        for e in shared:
            assert b[e] <= a[e] * margin, (e, a[e], b[e])

    worse(v27, v29)
    worse(v27, v47)
    worse(v29, v49)
    assert v615 and 2.0 in v27
    assert max(v615) < min(e for e in v27 if e >= 2.0)
    assert v615[max(v615)] <= v27[2.0]


def test_cli_writes_the_points_of_ber_curve(tmp_path, capsys):
    out, doc = tmp_path / "c.json", tmp_path / "c.md"
    rec = ber_curve.main(["--device", "cpu", "--backend", "torch", "--ebn0", "1", "3",
                          "--frame-bytes", "32", "--batch", "16", "--min-errors", "20",
                          "--max-bits", "20000", "--json", str(out), "--doc", str(doc)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec)) and rec["card"] == "CPU"
    assert doc.read_text() == ber_curve.render(**rec) == capsys.readouterr().out
    code, spec = P.VITERBI27, P.soft16_spec(2)

    def decode(syms):
        return P.decode_symbols(code, spec, syms, 32 * 8, backend="torch", device="cpu")

    want = ber.ber_curve(code, spec, [1.0, 3.0], frame_bytes=32, batch=16, min_errors=20,
                         max_bits=20000, seed=0, decode=decode, device="cpu")
    got = [{k: v for k, v in p.items() if k != "seconds"} for p in rec["points"]]
    assert got == [{k: v for k, v in ber_curve.point_record(p, 0.0).items() if k != "seconds"}
                   for p in want]
    assert got[0]["errors"] > got[1]["errors"] > 0
