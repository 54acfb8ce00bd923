"""The port's copy of the topology models, and the twins of the quickstart
and of fig13's HLO counts, on the CPU.

* ``repro_torch.core.topology`` against ``repro.core.topology``: the paper's
  1,024-accelerator Hx2Mesh and nonblocking fat tree (accelerators, cost,
  bisection, diameter), and every public model's structure at a few sizes.
* ``examples/quickstart_torch.py --device cpu`` runs its four parts and
  prints what the JAX quickstart prints for parts 1-3.
* ``benchmarks/fig13_allreduce_torch.py --device cpu``: each algorithm's
  per-rank sends against the rings' closed forms; the rings call no psum.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import topology as T  # noqa: E402
from repro_torch.core import topology as PT  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _facts(topo):
    s = topo.structure()
    return (topo.num_accelerators, dataclasses.asdict(s), getattr(topo, "bisection_fraction", None),
            getattr(topo, "diameter", None))


def test_paper_topologies_match_the_original():
    for make in (lambda M: M.HxMesh(a=2, b=2, x=16, y=16), lambda M: M.FatTree(1024, taper=0.0)):
        got, want = make(PT), make(T)
        assert _facts(got) == _facts(want)
    hx = PT.HxMesh(a=2, b=2, x=16, y=16)
    assert (hx.num_accelerators, hx.diameter) == (1024, 4)
    assert math.isclose(hx.bisection_fraction, 0.25)


@pytest.mark.parametrize("make", [
    lambda M: M.HxMesh(a=4, b=4, x=8, y=8), lambda M: M.HxMesh(a=1, b=1, x=32, y=32),
    lambda M: M.FatTree(4096, taper=0.5), lambda M: M.Dragonfly(a=8, p=4, h=4, groups=9),
    lambda M: M.Torus2D(32, 32)])
def test_models_match_the_original(make):
    assert _facts(make(PT)) == _facts(make(T))


def _run(script, *args):
    res = subprocess.run([sys.executable, str(REPO / script), *args], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.splitlines()


def test_quickstart_twin_runs_on_the_cpu():
    lines = _run("examples/quickstart_torch.py", "--device", "cpu")
    assert lines[0] == "Hx2Mesh: 1024 accels, cost $5.4M, bisection 0.25, diameter 4"
    assert lines[1] == "nonblocking fat tree costs $25.3M (4.7x more)"
    assert lines[3:5] == ["allreduce of 1e+05 B on 64 devices -> torus (33 us)",
                          "allreduce of 1e+09 B on 64 devices -> hamiltonian (2628 us)"]
    assert sum(line.startswith("step ") for line in lines) == 4
    assert lines[-1] == "quickstart OK"


def test_fig13_twin_counts_sends_and_psums():
    import json

    rows = {r["algo"]: r for r in map(json.loads, _run("benchmarks/fig13_allreduce_torch.py",
                                                        "--device", "cpu"))}
    size = 4 << 20
    assert rows["psum"]["psum_calls_per_rank"] == 1 and rows["psum"]["permutes_per_rank"] == 0
    for algo in ("ring", "bidir", "torus", "hamiltonian"):
        r = rows[algo]
        assert r["psum_calls_per_rank"] == 0 and r["permutes_per_rank"] > 0 and r["uniform"]
        assert r["max_abs_err"] == 0.0
    # a ring allreduce over 4 ranks sends 2 (p - 1) / p of the buffer; ring and
    # bidir do one over each of the two axes
    assert rows["ring"]["bytes_per_rank"] == rows["bidir"]["bytes_per_rank"] == 2 * (
        2 * 3 * size // 4)
    assert rows["ring"]["permutes_per_rank"] == 2 * 2 * 3
