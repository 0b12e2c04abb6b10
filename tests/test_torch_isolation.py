"""The port stands alone: it imports neither ``jax`` nor the JAX package,
builds nothing at import, and never runs on the CPU unless asked to."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import ka9q_viterbi_comparison_tpu_torch as P

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "ka9q_viterbi_comparison_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ka9q_viterbi_comparison_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "bench_torch.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_imports_without_jax_in_a_subprocess():
    """With ``jax`` and the JAX package made unimportable, every module of
    the port imports, and no kernel build is started."""
    code = """
import sys, pkgutil, importlib
sys.modules["jax"] = None
sys.modules["ka9q_viterbi_comparison_tpu"] = None
import ka9q_viterbi_comparison_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from ka9q_viterbi_comparison_tpu_torch.ops.cuda import _build
assert _build.library.cache_info().currsize == 0, "a build ran at import"
assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items() if v is not None)
print("isolated ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated ok" in out.stdout


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    code, numeric = P.VITERBI27, P.soft8_spec(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.ViterbiDecoder(code, numeric, batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.decode_symbols(code, numeric, torch.zeros((2, 28), dtype=torch.int32), 8)
    P.ViterbiDecoder(code, numeric, batch=2, device="cpu")  # asking for the CPU works


def test_exports_mirror_jax_package():
    expected = {"CodeSpec", "NumericSpec", "ViterbiDecoder", "decode_frames", "decode_fn",
                "decode_symbols", "VITERBI27", "VITERBI47", "VITERBI29", "VITERBI49",
                "VITERBI615", "VITERBI224", "STANDARD_CODES", "BENCH_FRAME_BYTES",
                "ka9q_offset_binary_spec", "soft16_spec", "soft8_spec", "hard8_spec",
                "__version__"}
    assert set(P.__all__) == expected
    for name in P.__all__:
        assert hasattr(P, name)
