"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; a run without a card exits
non-zero and prints no result."""

import ast
import os
import shutil
import subprocess
import sys

from conftest import ROOT
from portbench import harness

JAX = {"jax", "jaxlib", "flax", "mcpt_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_in_the_benchmark():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert not set(_imports(path)) & (JAX | {"mcpt_tpu_torch"}), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcpt_tpu_torch_probe", sys)
    assert "mcpt_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mcpt_tpu.probe", sys)
    assert "mcpt_tpu" in harness.forbidden_modules()


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cornell-box.preview",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_no_card_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
