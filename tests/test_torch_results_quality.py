"""The port's checked-in matrix against its gate, and the results file
generated from it.

The port's counterpart of ``tests/test_results_quality.py``:
``data/benchmark_torch.json`` (the runner's rows on an H100) passes every
rule of ``harness/check_results.py``, and ``RESULTS_TORCH.md`` is
``harness/make_results.py`` ``render()`` of it byte for byte, titled with the
card and its power limit as ``nvidia-smi`` printed them at the refresh, and
stating no TPU figure.  Every ``gpu_cuda`` row is compared in both phases and
none loses; and the port's own tabulation prints what
``scripts/tabulate_data.py`` prints on the same JSON.  The matrix and the
results file are checked in, so nothing here skips."""

import io
import json
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from ka9q_viterbi_comparison_tpu_torch.harness import check_results, make_results

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data" / "benchmark_torch.json"
RESULTS = REPO / "RESULTS_TORCH.md"


# The card the matrix was measured on, as nvidia-smi named it at the refresh.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def test_published_matrix_is_claim_grade():
    problems = check_results.check(str(DATA))
    assert not problems, "\n".join(problems)


def test_results_md_is_generated_from_the_data():
    """``RESULTS_TORCH.md`` == ``render(DATA, CARD)``: no claim in it is
    written by hand.  Its title names the card and its power limit, it lists
    every losing cell, holds the tabulation of the JSON, and states no TPU
    figure."""
    text = RESULTS.read_text()
    assert text == make_results.render(str(DATA), CARD), (
        "RESULTS_TORCH.md does not match regeneration from data/benchmark_torch.json; run: "
        f"python -m ka9q_viterbi_comparison_tpu_torch.harness.make_results "
        f"data/benchmark_torch.json --chip-name \"{CARD}\"")
    assert text.splitlines()[0] == make_results.TITLE + CARD
    assert re.fullmatch(r"NVIDIA .+, \d+\.\d+ W", CARD)
    rows = json.loads(DATA.read_text())
    assert all(c in text for c in check_results.losing_cells(rows))
    assert make_results.tables(str(DATA)) in text
    assert "TPU" not in text and "tpu_pallas" not in text and "tpu_jnp" not in text


def test_every_cuda_cell_beats_its_baseline_column():
    rows = json.loads(DATA.read_text())
    losses = [c for c in check_results.losing_cells(rows) if c.startswith("gpu_cuda")]
    assert not losses, "\n".join(losses)
    covered = [e for e in check_results.vs_baseline_rows(rows) if e["name"].startswith("gpu_cuda")]
    assert len(covered) == 16, "the matrix holds the runner's 16 gpu_cuda rows"
    for e in covered:
        assert "update" in e and "chainback" in e, (
            f"{e['name']} K={e['K']} R={e['R']}: missing comparison column")


def test_matrix_holds_every_family():
    """Six codes, 16 rows a family: the CUDA kernels, the portable path and
    the host decoder."""
    rows = json.loads(DATA.read_text())
    names = {r["name"].removesuffix("_s16").removesuffix("_ob") for r in rows}
    assert names == {"gpu_cuda", "gpu_torch", "cpu_native"}
    assert len(rows) == 48
    assert {(r["K"], r["R"]) for r in rows} == {(7, 2), (7, 4), (9, 2), (9, 4), (15, 6), (24, 2)}


def test_tabulation_matches_tabulate_data():
    sys.path.insert(0, str(REPO / "scripts"))
    import tabulate_data

    buf = io.StringIO()
    saved = sys.argv
    sys.argv = ["tabulate_data", str(DATA)]
    try:
        with redirect_stdout(buf):
            tabulate_data.main()
    finally:
        sys.argv = saved
    assert make_results.tables(str(DATA)) == buf.getvalue()


def test_render_refuses_a_matrix_the_gate_fails(tmp_path):
    rows = json.loads(DATA.read_text())
    rows[0]["bit_error_rate"] = 0.25
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(rows))
    with pytest.raises(SystemExit, match="not claim-grade"):
        make_results.render(str(bad), CARD)
