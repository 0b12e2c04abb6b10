"""The port's plots: ``harness/make_results.py`` runs ``scripts/plot_data.py``
unchanged on the checked-in matrix and keeps its two charts as
``docs/plot_torch_*.png``, leaving the JAX package's ``docs/plot_*.png`` as
they are; ``RESULTS_TORCH.md`` links the checked-in charts.  The cases that
draw skip where matplotlib is absent; no pixels are compared."""

import subprocess
from pathlib import Path

import pytest

from ka9q_viterbi_comparison_tpu_torch.harness import make_results

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data" / "benchmark_torch.json"
RESULTS = REPO / "RESULTS_TORCH.md"
JAX_PLOTS = [REPO / "docs" / "plot_symbol_update.png", REPO / "docs" / "plot_chainback.png"]
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def test_make_results_draws_both_plots(monkeypatch, tmp_path):
    """Run from ``tmp_path``: the results file and ``docs/`` go there."""
    pytest.importorskip("matplotlib")
    before = {p: p.read_bytes() for p in JAX_PLOTS}
    monkeypatch.chdir(tmp_path)
    out, plot_dir = tmp_path / "RESULTS_TORCH.md", tmp_path / "docs"
    make_results.main([str(DATA), "--chip-name", CARD, "--out", str(out)])
    assert out.read_text() == make_results.render(str(DATA), CARD)
    assert sorted(p.name for p in plot_dir.iterdir()) == sorted(make_results.PLOTS.values()), (
        "the two charts and nothing else: the temporary directory is gone")
    for name in make_results.PLOTS.values():
        data = (plot_dir / name).read_bytes()
        assert len(data) > 1000 and data.startswith(PNG_MAGIC)
    assert {p: p.read_bytes() for p in JAX_PLOTS} == before


def test_plot_command_names_the_card_and_baseline(monkeypatch, tmp_path):
    """The script runs by its path (it imports its neighbours), on the given
    matrix, titled with the card, normalised to ``gpu_torch``."""
    calls = []

    def run(cmd, check):
        calls.append(cmd)
        out_dir = Path(cmd[cmd.index("--out-dir") + 1])
        for name in make_results.PLOTS:
            (out_dir / name).write_bytes(PNG_MAGIC)

    monkeypatch.setattr(subprocess, "run", run)
    paths = make_results.plots(str(DATA), CARD, str(tmp_path))
    (cmd,) = calls
    assert cmd[1] == str(REPO / "scripts" / "plot_data.py") and cmd[2] == str(DATA)
    assert cmd[cmd.index("--chip-name") + 1] == CARD
    assert cmd[cmd.index("--baseline") + 1] == make_results.PLOT_BASELINE == "gpu_torch"
    assert Path(cmd[cmd.index("--out-dir") + 1]).parent == tmp_path
    assert paths == [str(tmp_path / n) for n in make_results.PLOTS.values()]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(make_results.PLOTS.values())


def test_no_plots_writes_the_results_only(monkeypatch, tmp_path):
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("plot_data.py ran"))
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "RESULTS_TORCH.md"
    make_results.main([str(DATA), "--chip-name", CARD, "--out", str(out), "--no-plots"])
    assert out.read_text() == make_results.render(str(DATA), CARD)
    assert not (tmp_path / "docs").exists()


def test_results_md_links_the_checked_in_plots():
    text = RESULTS.read_text()
    assert "`gpu_torch`" in text.split("## Plots", 1)[1]
    for name in make_results.PLOTS.values():
        assert f"(docs/{name})" in text
        assert (REPO / "docs" / name).read_bytes().startswith(PNG_MAGIC)
