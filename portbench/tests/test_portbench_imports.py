"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            names |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.module and not n.level:
            names.add(n.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_of_the_benchmark_imports_jax(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_the_reference_imports_nothing_of_the_port(path):
    assert not _imports(path) & {harness.PORT, *harness.FORBIDDEN}


def test_a_run_loads_no_jax_module():
    """A tiny CPU run of every mode in a fresh process, then
    `sys.modules` by top-level name."""
    code = (
        "import sys, json\n"
        "from portbench.tests.tiny import run_tiny\n"
        "run_tiny('infer-full-f32', trace=1)\n"
        "run_tiny('train-bf16-b12')\n"
        "from portbench import harness\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", sys)
    monkeypatch.setitem(sys.modules, "regnet_for_3d_grasping_tpu_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax"]
