"""No module of the benchmark imports JAX, the JAX package or its old
benchmark folder, by top-level name compared whole; the reference imports
nothing of the program; and a run's process checks what it loaded."""
import ast
import subprocess
import sys

import pytest

from _helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted((ROOT / "bench").rglob("*.py"))


def imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not set(imported(path)) & FORBIDDEN


def test_reference_and_yardstick_stand_alone():
    for sub in ("reference", "yardstick"):
        for path in (ROOT / "bench" / sub).rglob("*.py"):
            assert set(imported(path)) <= {"__future__", "math", "torch",
                                           "numpy"}, path


def test_whole_names_compared(monkeypatch):
    """``repro_torch`` begins with ``repro`` and is allowed; ``repro`` and
    its submodules are not."""
    import types
    sys.path.insert(0, str(ROOT / "bench"))
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_probe",
                        types.ModuleType("repro_torch_probe"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert run.forbidden_modules() == ["repro"]


def test_run_refuses_without_a_card():
    """Without CUDA the command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "vc1m_coo_grad", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
