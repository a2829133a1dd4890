"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level names are compared
whole: the port's name, shadernn_tpu_torch, begins with the JAX package's."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "shadernn_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                                               recursive=True)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH, "reference", "*.py"))))
def test_the_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (JAX | {"shadernn_tpu_torch"})


def test_top_level_names_are_compared_whole():
    from benchmark.harness import core

    sys.modules.setdefault("shadernn_tpu_torch_probe", sys)  # starts with the JAX package's name
    try:
        assert "shadernn_tpu" not in core.forbidden_modules()
    finally:
        del sys.modules["shadernn_tpu_torch_probe"]


def test_a_run_loads_no_jax_module():
    """A whole (small, CPU) run of every cell in a fresh interpreter, then
    the loaded modules' top-level names."""
    code = f"""
import sys, time
sys.path.insert(0, {ROOT!r}); sys.path.insert(0, {os.path.dirname(__file__)!r})
from conftest import TINY, run_tiny, tiny_cell
for name in sorted(TINY):
    run_tiny(tiny_cell(name), seconds=0.2, trace=name.endswith("b8"))
from benchmark.harness import core
print("LOADED", ",".join(core.forbidden_modules()))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("LOADED")][-1]
    assert line == "LOADED ", line
