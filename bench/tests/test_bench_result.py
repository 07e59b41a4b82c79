"""The result line, the run without a card, and what the benchmark loads."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from bench import harness as H
from conftest import run_tiny

CELLS = ["select.cifar10_vitb16.dense", "select.cifar10_vitb16.gramfree_lazy",
         "lm_train.internlm2_1_8b.seq4096"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(run_module, manifest, trace):
    out = run_tiny(run_module, manifest, "select.cifar10_vitb16.dense", trace=trace)
    line = H.result_line(correct=out["correct"], attempted=out["attempted"],
                         failed=out["failed"], metrics=out["metrics"],
                         device={"platform": "gpu", "kind": "x", "count": 1,
                                 "memory_peak_bytes": 0},
                         checks=out["checks"], breakdown=out["breakdown"])
    obj = json.loads(line)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(obj)[:5] == want
    assert list(obj)[5:] == (["breakdown", "checks"] if trace else ["checks"])
    for c in obj["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert all(len(obj["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(H.BENCH / "run.py"), "--workload", CELLS[0],
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, cwd=H.ROOT, timeout=300)
    assert proc.returncode != 0
    assert not any(l.startswith("{") for l in proc.stdout.splitlines())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for path in H.BENCH.rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & set(H.FORBIDDEN_MODULES), path
        if "reference" in path.relative_to(H.BENCH).parts:
            assert "repro_torch" not in tops, path


def test_forbidden_modules_compare_whole_top_level_names():
    assert H.forbidden_loaded({"repro_torch": 0, "repro_torch.core": 0, "jaxtyping": 0}) == []
    assert H.forbidden_loaded({"repro.core.milo": 0}) == ["repro"]
    assert H.forbidden_loaded({"jax.numpy": 0, "jaxlib": 0}) == ["jax", "jaxlib"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_neither_jax_nor_the_jax_package(cell):
    code = (
        "import sys, time, torch\n"
        "sys.path[:0] = ['src', '.']\n"
        "from conftest import load_run_module, run_tiny\n"
        "from bench import harness as H\n"
        f"out = run_tiny(load_run_module(), H.load_manifest(), {cell!r}, trace=True)\n"
        "assert out['correct'], out['checks']\n"
        "print(H.forbidden_loaded())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(H.BENCH / "tests"), str(H.ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=H.ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
