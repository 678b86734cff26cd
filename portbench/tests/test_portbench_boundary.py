"""What the benchmark may import, and what a run does without a card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _sources(sub=""):
    return sorted(p for p in (BENCH / sub).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_references_import_nothing_of_the_port():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"repro_torch"}, (path, name)
            assert top in {"__future__", "contextlib", "importlib", "math",
                           "typing", "torch", "portbench"}, (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)


def _run(cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "starcoder2-3b.prefill_repo", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def _no_result(out: str):
    for line in out.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        pytest.fail(f"a result was printed: {line[:200]}")


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    _no_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    _no_result(proc.stdout)
