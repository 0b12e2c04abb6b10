"""Nothing a run imports is JAX or the JAX package, and the reference
imports nothing of the program.  Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import ast
import json
import pathlib
import subprocess
import sys

from perfbench.cell import FORBIDDEN

ROOT = pathlib.Path(__file__).resolve().parents[2]
PORT = "ka9q_viterbi_comparison_tpu_torch"


def _loaded_after(code: str) -> set[str]:
    """Top-level names in ``sys.modules`` of a fresh interpreter that ran
    ``code`` from the root of the checkout."""
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    done = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax():
    names = _loaded_after(
        "import runpy\n"
        "runpy.run_path('perfbench/run.py', run_name='perfbench_run')\n"
        "import json, pathlib, perfbench.control\n"
        "from perfbench import spec\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for m in bench['per_layer'] + bench['end_to_end']: spec.reader(m['name'])\n"
        "from perfbench import entries\n"
        "for path in pathlib.Path('perfbench/entries').glob('[a-z]*.py'):\n"
        "    if path.stem != 'common': entries.load(path.stem)\n")
    assert PORT in names  # the run does load the program
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))


def test_reference_imports_nothing_of_the_program():
    names = _loaded_after("import perfbench.reference.viterbi, perfbench.reference.channel")
    assert PORT not in names and not names & set(FORBIDDEN)
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] in ("torch", "numpy", "dataclasses", "__future__"), \
                    f"{path.name} imports {mod}"
