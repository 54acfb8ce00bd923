"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

_PROBE = r"""
import sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
from portbench import check, control, feed, flops, harness, spread, trace, weights
from portbench.reference import model
import run  # portbench/run.py, as the command runs it
from repro_torch.train import steps  # what a run imports of the program
for name in {names!r}:
    harness.load_metric(name)
for workload in {workloads!r}:
    harness.load_cell(workload, traced=True)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _names():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return ([m["name"] for m in bench["end_to_end"] + bench["per_layer"]],
            [w["name"] for w in bench["workloads"]])


def test_a_run_loads_no_jax_and_no_jax_package():
    metrics, workloads = _names()
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), names=metrics,
                         workloads=workloads)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=HERE, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = ast.literal_eval(res.stdout.strip().splitlines()[-1])
    assert "repro_torch" in loaded
    assert not set(loaded) & set(FORBIDDEN), set(loaded) & set(FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    roots = {m.split(".")[0] for m in _imports(path)}
    assert not roots & set(FORBIDDEN), f"{path.name} imports {roots & set(FORBIDDEN)}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_the_reference_imports_nothing_of_the_program_or_the_harness(path):
    roots = {m.split(".")[0] for m in _imports(path)}
    assert roots <= {"__future__", "math", "torch"}, roots


def test_the_check_compares_whole_top_level_names(monkeypatch):
    import types

    from portbench import harness

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == sorted(set(before) | {"jax"})
    assert "repro_torch_like" not in harness.forbidden_modules()
