"""The port's abstract specs, ``TraceMesh`` and dry-run against the JAX
package, on the CPU.

* ``input_specs``, ``abstract_params`` and ``abstract_cache`` have the shapes
  and dtypes of JAX's ``eval_shape`` stand-ins for the 10 assigned archs and
  gpt3-paper at full size, for every valid cell shape, and allocate nothing.
* ``arg_bytes_per_device`` equals JAX's ``memory_analysis()
  .argument_size_in_bytes`` exactly on the 16 × 16 (and one 2 × 16 × 16) mesh
  of fake devices, at smoke size; and the wire model equals JAX's
  ``collective_stats`` on hand-written HLO lines of each kind and group size.
  Both JAX numbers come from one subprocess (``python
  tests/test_torch_dryrun.py OUT.json``), since importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices.
* ``TraceMesh``'s ``CommStats`` for rank r equal those of a real 4 × 4
  ``LocalMesh`` run of the same train step for rank r, for every sync mode,
  top-k compression and the MoE family's ``moe_mode="ep"``.
* ``roofline_torch.model_flops`` equals ``benchmarks/roofline.py``'s.

The trace against real steps is in ``test_torch_dryrun_trace.py``;
``run_cell`` over every smoke cell in ``test_torch_dryrun_cells_*.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import abstract_cache as jabstract_cache  # noqa: E402
from repro.configs import abstract_params as jabstract_params  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import input_specs as jinput_specs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, abstract_cache,  # noqa: E402
                                 abstract_params, get_config, input_specs, valid_cells)
from repro_torch.core.comm import LocalMesh, TraceMesh  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.parallel.sharding import Policy  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as st  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = [*ASSIGNED_ARCHS, "gpt3-paper"]

# the cells whose at-rest bytes are held to JAX's (smoke size): (arch, shape, multi_pod)
ARG_CELLS = [("llama3.2-3b", "train_4k", False), ("llama3.2-3b", "prefill_32k", False),
             ("llama3.2-3b", "decode_32k", False), ("moonshot-v1-16b-a3b", "train_4k", False),
             ("mamba2-130m", "decode_32k", False), ("llama3.2-3b", "train_4k", True)]
# hand-written HLO collectives: (kind, dtype, result dims, group size, iota groups)
HLO_CASES = [("all-reduce", "f32", (1024,), 4, False), ("all-reduce", "bf16", (16, 64), 16, True),
             ("all-reduce", "f32", (8,), 1, False), ("all-gather", "bf16", (16, 64), 16, True),
             ("all-gather", "f32", (4, 3), 4, False), ("reduce-scatter", "f32", (256,), 16, False),
             ("all-to-all", "bf16", (4, 2, 8), 4, False),
             ("collective-permute", "f32", (1000,), 1, False)]
_HLO_BYTES = {"f32": 4, "bf16": 2}


def _hlo_line(kind, dtype, dims, group, iota):
    layout = ",".join(map(str, range(len(dims) - 1, -1, -1)))
    shape = f"{dtype}[{','.join(map(str, dims))}]{{{layout}}}"
    if kind == "collective-permute":
        extra = "source_target_pairs={{0,1},{1,0}}"
    elif iota:
        extra = f"replica_groups=[{256 // group},{group}]<=[256]"
    else:
        extra = "replica_groups={{" + ",".join(map(str, range(group))) + "}}"
    return f"  %op.1 = {shape} {kind}({shape} %p), {extra}, to_apply=%add"


def _jax_reference(out_path: str) -> None:
    """The subprocess: JAX's argument bytes of ARG_CELLS and its collective_stats
    of each HLO_CASES line, as JSON."""
    from repro.launch import dryrun as jd  # sets XLA_FLAGS: 512 host devices
    from repro.launch.mesh import make_production_mesh
    from repro.train import steps as jsteps

    args = {}
    for arch, shape, multi in ARG_CELLS:
        mesh = make_production_mesh(multi_pod=multi)
        fn, a = jd.build_cell(arch, shape, mesh, multi, jsteps.TrainOptions(), smoke=True)
        args[f"{arch}/{shape}/{multi}"] = fn.lower(*a).compile().memory_analysis(
        ).argument_size_in_bytes
    stats = [jd.collective_stats(_hlo_line(*c)) for c in HLO_CASES]
    with open(out_path, "w") as f:
        json.dump({"args": args, "stats": stats}, f)


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "jax.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(out)],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# abstract specs
# ---------------------------------------------------------------------------


def _jax_sig(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree)


def _sig(tree):
    flat, spec = tree_lib.flatten(tree)
    assert all(t.device.type == "meta" for t in flat)
    return tree_lib.unflatten(spec, [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                                     for t in flat])


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_specs_match_jax_eval_shape(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert _sig(abstract_params(cfg)) == _jax_sig(jabstract_params(jcfg))
    assert _sig(abstract_params(cfg, dtype=torch.float32)) == _jax_sig(
        jabstract_params(jcfg, dtype=jax.numpy.float32))
    for shape in valid_cells(arch):
        assert _sig(input_specs(cfg, shape)) == _jax_sig(jinput_specs(jcfg, shape)), shape
        if SHAPES[shape].kind == "decode":
            b, s = SHAPES[shape].global_batch, SHAPES[shape].seq_len
            assert _sig(abstract_cache(cfg, b, s)) == _jax_sig(jabstract_cache(jcfg, b, s)), shape


# ---------------------------------------------------------------------------
# against JAX's compiled cells and HLO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,multi", ARG_CELLS)
def test_arg_bytes_per_device_equal_jax(arch, shape, multi, jax_reference):
    cell = dryrun.build_cell(arch, shape, multi, st.TrainOptions(), smoke=True)
    assert cell.arg_bytes_per_device == jax_reference["args"][f"{arch}/{shape}/{multi}"]


def test_arg_bytes_of_the_measured_cell():
    # the JAX dry-run's memory_analysis of llama3.2-3b-smoke train_4k on 16 x 16
    cell = dryrun.build_cell("llama3.2-3b", "train_4k", False, st.TrainOptions(), smoke=True)
    assert cell.arg_bytes_per_device == 615_172


@pytest.mark.parametrize("case", range(len(HLO_CASES)))
def test_wire_model_equals_jax_collective_stats(case, jax_reference):
    kind, dtype, dims, group, _ = HLO_CASES[case]
    nbytes = int(np.prod(dims)) * _HLO_BYTES[dtype]
    assert dryrun.collective_stats([(kind, nbytes, group)]) == jax_reference["stats"][case]


# ---------------------------------------------------------------------------
# TraceMesh
# ---------------------------------------------------------------------------

SYNC_CASES = ["psum", "ring", "bidir", "torus", "hamiltonian", "compress_k", "ep"]


def _sync_setup(case):
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    if case == "ep":
        cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b-smoke"), moe_mode="ep")
        return cfg, ocfg, st.TrainOptions(sync="psum"), Policy(data_axes=("data",)), 8
    opts = (st.TrainOptions(sync="ring", compress_k=8) if case == "compress_k"
            else st.TrainOptions(sync=case))
    return get_config("llama3.2-3b-smoke"), ocfg, opts, Policy(data_axes=("data", "model")), 16


def _run_step(cfg, ocfg, opts, policy, mesh, batch):
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                        dtype=torch.float32)
    step = st.make_train_step(cfg, ocfg, opts, policy, mesh)
    _, _, m = step(params, opt.init(params), batch)
    return m


@pytest.mark.parametrize("case", SYNC_CASES)
def test_trace_mesh_counts_what_local_mesh_counts_rank_by_rank(case):
    cfg, ocfg, opts, policy, rows = _sync_setup(case)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 16, rows).items()}
    axes = ("data", "model")
    local = LocalMesh((4, 4), axes, "cpu", timeout=120)
    _run_step(cfg, ocfg, opts, policy, local, batch)
    ref = local.stats
    assert ref.psum_calls + ref.all_to_all_calls + sum(ref.messages.values()) > 0
    calls = {"psum": 0, "all_gather": 0, "all_to_all": 0}
    for r in range(local.size):
        mesh = TraceMesh((4, 4), axes, ranks=(r,))
        m = _run_step(cfg, ocfg, opts, policy, mesh, batch)
        assert np.isfinite(float(m["loss"]))
        got = mesh.stats
        assert dict(got.bytes) == {k: v for k, v in ref.bytes.items() if k[0] == r}
        assert dict(got.messages) == {k: v for k, v in ref.messages.items() if k[0] == r}
        for kind in calls:
            calls[kind] += getattr(got, f"{kind}_calls")
        assert {rank for rank, *_ in mesh.calls} == {r}
    assert calls == {"psum": ref.psum_calls, "all_gather": ref.all_gather_calls,
                     "all_to_all": ref.all_to_all_calls}


def test_trace_mesh_runs_the_ranks_asked_in_the_calling_thread():
    mesh = TraceMesh((2, 4), ("data", "model"), ranks=(5, 2))
    x = torch.arange(6.0).reshape(2, 3)

    def body(comm, v):
        assert threading.current_thread() is threading.main_thread()
        perm = comm.ppermute(v, "model", [(0, 1), (1, 2), (2, 3)])
        return (comm.rank, comm.psum(v, "data").shape, comm.all_gather(v, "model").shape,
                comm.all_to_all(torch.zeros(4, 3), "model").shape, perm)

    out = mesh.run(body, [x * i for i in range(8)])
    assert [o[0] for o in out] == [5, 2]
    assert all(o[1:4] == ((2, 3), (4, 2, 3), (4, 3)) for o in out)
    # rank 5 sits at model position 1 (a pair sends to it); rank 2 at 2
    assert torch.equal(out[0][4], x * 5) and torch.equal(out[1][4], x * 2)
    # the ppermute's 24 B to the next model position, and an all_to_all entry
    # of 12 B to each other rank of the model group
    assert dict(mesh.stats.bytes) == {(5, 6): 36, (5, 4): 12, (5, 7): 12,
                                      (2, 3): 36, (2, 0): 12, (2, 1): 12}
    assert [c[1] for c in mesh.calls] == ["collective-permute", "all-reduce", "all-gather",
                                          "all-to-all"] * 2
    assert [c[3] for c in mesh.calls[:4]] == [1, 2, 4, 4]


def test_roofline_twin_model_flops_equal_jax():
    sys.path.insert(0, str(REPO))
    from benchmarks import roofline as jroof
    from benchmarks import roofline_torch as roof

    for arch in ARCHS:
        for shape in SHAPES:
            assert roof.model_flops(arch, shape) == jroof.model_flops(arch, shape)
    rec = dryrun.run_cell("mamba2-130m", "long_500k", False, st.TrainOptions(), smoke=True)
    row = roof.row(rec)
    a = roof.analyse(rec)
    assert row["dominant"] == a["dominant"] == max(("compute", "memory", "collective"),
                                                   key=lambda k: a[f"t_{k}"])
    assert a["t_compute"] == rec["flops"] / roof.PEAK_FLOPS


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
