"""The sharding rules, the production mesh and sharded checkpoints of the port
against the JAX package, on the CPU.

* ``default_policy``, ``param_specs``, ``batch_specs``, ``cache_specs``,
  ``sanitize_specs`` and ``activation_specs`` of ``repro_torch`` against
  ``repro``'s, leaf for leaf, for the 10 assigned archs and gpt3-paper at
  full size, under both layouts, on the single-pod (16, 16) mesh, the
  multi-pod (2, 16, 16) mesh and a small (2, 4) one.  The parameter shapes
  are JAX's ``eval_shape`` of its init as meta tensors (the port keys its
  rules on the same names); the caches are the port's own ``init_cache`` on
  the meta device; JAX's ``activation_specs`` runs on an ``AbstractMesh``.
* ``sanitize_specs`` drops the split of minicpm-2b's vocabulary of 122753.
* ``NamedSharding.put`` and ``Sharded.gather``: every rank's block is the
  slice its spec names (computed here from the mesh coordinates), and the
  blocks put back together are the tensor, bit for bit.
* The counterpart of ``check_elastic_resharding``
  (``tests/multidevice_checks.py``): a state saved from a (4, 4) mesh
  restores on a (2, 8) mesh with ``w`` as ``P("model", "data")`` and ``b`` as
  ``P(None)``, bit for bit; and a checkpoint written by the JAX package
  restores sharded into the port.
* The same cut and gather on a ``DistMesh`` of 4 gloo processes (a
  ``FileStore`` rendezvous): each process holds its own block only, and
  ``gather`` (an all_gather) gives every process the whole tensor.
* ``make_production_mesh``: its shapes and axes, a ``LocalMesh`` with
  ``device``, a ``DistMesh`` under a process group of 256 ranks is refused
  for a group of 1, and without either it raises.
"""

import functools
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.core.comm import LocalMesh  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.sharding import P  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = [*ASSIGNED_ARCHS, "gpt3-paper"]
MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}
BATCH, CACHE_LEN = 32, 64


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch):
    cfg = jget_config(arch)
    return jax.eval_shape(lambda k: jget_model(cfg).init_params(cfg, k, dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))


def _as_meta(tree):
    """JAX's shape tree as meta tensors, a dict tree as the port's."""
    if isinstance(tree, dict):
        return {k: _as_meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


def _spec_leaves(tree):
    """The specs of a JAX or port spec tree in flatten order, as tuples."""
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, (jax.sharding.PartitionSpec,
                                                                    P)))
    return [tuple(s) for s in leaves]


def _names(tree, prefix=""):
    out = []
    for k in sorted(tree):
        out += _names(tree[k], f"{prefix}{k}.") if isinstance(tree[k], dict) else [prefix + k]
    return out


def _abstract_mesh(shape, axes):
    try:
        return AbstractMesh(shape, axes)
    except TypeError:  # jax 0.4.x: one tuple of (name, size)
        return AbstractMesh(tuple(zip(axes, shape)))


class _ShapeOnly:
    """A mesh that is only a ``.shape``, as JAX's batch and cache rules read one."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("layout", ["2d", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_functions_match_jax(arch, layout, mesh_kind):
    shape, axes = MESHES[mesh_kind]
    multi = "pod" in axes
    cfg, jcfg = get_config(arch), jget_config(arch)
    policy, jpolicy = sh.default_policy(cfg, multi, layout), jsh.default_policy(jcfg, multi, layout)
    assert dataclass_tuple(policy) == dataclass_tuple(jpolicy)
    mesh = LocalMesh(shape, axes, "cpu")  # no thread runs: the rules read its shape
    jmesh = _ShapeOnly(shape, axes)

    jshapes = _jax_param_shapes(arch)
    shapes = _as_meta(jshapes)
    assert _names(shapes) == _names(jshapes)
    specs, jspecs = sh.param_specs(cfg, shapes, policy), jsh.param_specs(jcfg, jshapes, jpolicy)
    assert _spec_leaves(specs) == _spec_leaves(jspecs)
    assert _spec_leaves(sh.sanitize_specs(shapes, specs, mesh)) == \
        _spec_leaves(jsh.sanitize_specs(jshapes, jspecs, jmesh))

    for batch in (BATCH, 3):  # one that the data axes divide, one that they do not
        assert {k: tuple(v) for k, v in sh.batch_specs(cfg, policy, mesh, batch).items()} == \
            {k: tuple(v) for k, v in jsh.batch_specs(jcfg, jpolicy, jmesh, batch).items()}
        cache = get_model(cfg).init_cache(cfg, batch, CACHE_LEN, device="meta")
        jcache = jax.eval_shape(lambda: jget_model(jcfg).init_cache(jcfg, batch, CACHE_LEN))
        assert _names(cache) == _names(jcache)
        cspecs = sh.cache_specs(cfg, cache, policy, mesh, batch)
        jcspecs = jsh.cache_specs(jcfg, jcache, jpolicy, jmesh, batch)
        assert _spec_leaves(cspecs) == _spec_leaves(jcspecs)
        assert _spec_leaves(sh.sanitize_specs(cache, cspecs, mesh)) == \
            _spec_leaves(jsh.sanitize_specs(jcache, jcspecs, jmesh))
        act = sh.activation_specs(cfg, policy, mesh, batch)
        jact = jsh.activation_specs(jcfg, jpolicy, _abstract_mesh(shape, axes), batch)
        assert {k: tuple(v.spec) for k, v in act.items()} == \
            {k: tuple(v.spec) for k, v in jact.items()}
        assert all(v.mesh is mesh for v in act.values())


def dataclass_tuple(policy):
    return (tuple(policy.data_axes), policy.model_axis, policy.fsdp, policy.tp, policy.dp,
            policy.fsdp_axis, policy.mp)


def test_sanitize_drops_the_split_of_an_odd_vocabulary():
    cfg = get_config("minicpm-2b")
    assert cfg.vocab == 122753
    mesh = mesh_lib.make_production_mesh(device="cpu")
    shapes = _as_meta(_jax_param_shapes("minicpm-2b"))
    specs = sh.param_specs(cfg, shapes, sh.default_policy(cfg))
    fixed = sh.sanitize_specs(shapes, specs, mesh)
    assert tuple(specs["embed"]) == ("model", "data")
    assert tuple(fixed["embed"]) == (None, "data")  # 122753 splits over neither 16
    assert tuple(fixed["layers"]["wq"]) == tuple(specs["layers"]["wq"])
    assert tuple(sh.sanitize_specs({"x": torch.empty(0, 9)}, {"x": P(None, ("data", "model"))},
                                   mesh)["x"]) == (None, None)


# ---------------------------------------------------------------------------
# blocks: put, gather, and the checkpoint across meshes
# ---------------------------------------------------------------------------


def _slice_of(mesh, rank, spec, shape):
    """The global slice ``rank`` should hold, from its coordinates: an entry's
    axes are the digits of the block index, the first the most significant."""
    coords = mesh.coords(rank)
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        parts, index = 1, 0
        for a in axes:
            parts *= mesh.shape[a]
            index = index * mesh.shape[a] + coords[a]
        size = n // parts
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def _check_blocks(x, sharded, spec):
    mesh = sharded.sharding.mesh
    assert sharded.shape == tuple(x.shape) and sharded.dtype == x.dtype
    for r in range(mesh.size):
        want = x[_slice_of(mesh, r, spec, x.shape)]
        assert torch.equal(sharded.blocks[r], want), (spec, r)
        assert sharded.blocks[r].is_contiguous()
    assert torch.equal(sharded.gather(), x)


@pytest.mark.parametrize("spec", [P("data", "model"), P("model", "data"), P(None, ("data", "model")),
                                  P(("model", "data")), P(), P(None, "model", "data")])
def test_put_cuts_each_rank_its_block_and_gather_restores(spec):
    mesh = LocalMesh((2, 4), ("data", "model"), "cpu")
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)
    if len(spec) == 3:
        x = torch.arange(2 * 8 * 4, dtype=torch.float32).reshape(2, 8, 4)
    _check_blocks(x, sh.NamedSharding(mesh, spec).put(x), spec)


def test_put_refuses_an_uneven_split():
    mesh = LocalMesh((2, 4), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="does not split"):
        sh.NamedSharding(mesh, P("model")).put(torch.zeros(6))


def _elastic_state():
    return {"w": torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32),
            "b": torch.ones(32, dtype=torch.bfloat16)}


def test_elastic_resharding_across_mesh_shapes(tmp_path):
    state = _elastic_state()
    mesh_a = LocalMesh((4, 4), ("data", "model"), "cpu")
    specs_a = {"w": P("data", "model"), "b": P("model")}
    state_a = sh.shard_tree(state, sh.to_shardings(mesh_a, specs_a))
    for k in state:
        _check_blocks(state[k], state_a[k], specs_a[k])
    ckpt.save(str(tmp_path / "c"), state_a, step=3)
    mesh_b = LocalMesh((2, 8), ("data", "model"), "cpu")
    specs_b = {"w": P("model", "data"), "b": P(None)}
    restored, step = ckpt.restore(str(tmp_path / "c"), state,
                                  shardings=sh.to_shardings(mesh_b, specs_b))
    assert step == 3
    for k in state:
        assert restored[k].sharding.mesh.shape == {"data": 2, "model": 8}
        _check_blocks(state[k], restored[k], specs_b[k])


def test_a_jax_checkpoint_restores_sharded(tmp_path):
    state = _elastic_state()
    jstate = {"w": jnp.asarray(state["w"].numpy()), "b": jnp.ones((32,), jnp.bfloat16)}
    jckpt.save(str(tmp_path / "j"), jstate, step=7)
    mesh = LocalMesh((2, 4), ("data", "model"), "cpu")
    specs = {"w": P(("data", "model")), "b": P("model")}
    restored, step = ckpt.restore(str(tmp_path / "j"), state,
                                  shardings=sh.to_shardings(mesh, specs))
    assert step == 7
    for k in state:
        _check_blocks(state[k], restored[k], specs[k])
    # and back: the port's save of the sharded state, read by the JAX package
    ckpt.save(str(tmp_path / "p"), restored, step=8)
    back, jstep = jckpt.restore(str(tmp_path / "p"), jstate)
    assert jstep == 8
    for k in state:
        np.testing.assert_array_equal(np.asarray(back[k], np.float32),
                                      state[k].float().numpy())


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(multi_pod):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    shape, axes = MESHES["multi" if multi_pod else "single"]
    assert isinstance(mesh, LocalMesh) and mesh.axis_names == axes
    assert mesh.shape == dict(zip(axes, shape)) and mesh.size == math.prod(shape)
    assert mesh.coords(mesh.size - 1) == {a: n - 1 for a, n in zip(axes, shape)}


def test_production_mesh_needs_ranks(tmp_path):
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="need 256 ranks"):
        mesh_lib.make_production_mesh()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "s"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs 512 ranks, the process group has 1"):
            mesh_lib.make_production_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["llama3.2-3b-smoke", "moonshot-v1-16b-a3b-smoke"])
@pytest.mark.parametrize("moe_mode", ["tp", "gshard"])
def test_activation_anchors_change_no_number(arch, moe_mode):
    """``forward`` takes ``activation_specs``' anchors ("act", "logits" and, for
    gshard, "experts") and computes what it computes without them."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch), moe_mode=moe_mode)
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    toks = torch.arange(2 * 12, dtype=torch.int32).reshape(2, 12) % cfg.vocab
    mesh = LocalMesh((2, 4), ("data", "model"), "cpu")
    act = sh.activation_specs(cfg, sh.Policy(), mesh, 2)  # tp on: the smoke width turns it off
    assert ("experts" in act) == (cfg.family == "moe" and moe_mode == "gshard")
    with torch.no_grad():
        want, want_aux = get_model(cfg).forward(cfg, params, toks)
        got, aux = get_model(cfg).forward(cfg, params, toks, act_specs=act)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


_DIST_WORKER = r"""
import sys
import torch
import torch.distributed as dist

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank, world_size=4)
from repro_torch.core.comm import DistMesh
from repro_torch.parallel import sharding as sh

mesh = DistMesh((2, 2), ("data", "model"))
x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
res = {}
for name, spec in (("dm", sh.P("data", "model")), ("both", sh.P(None, ("model", "data"))),
                   ("rep", sh.P())):
    s = sh.NamedSharding(mesh, spec).put(x)
    res[name] = (s.blocks, s.gather())
torch.save(res, out)
dist.destroy_process_group()
"""


@pytest.mark.timeout(300)
def test_dist_mesh_holds_its_own_block_and_gathers(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_WORKER, str(r), str(tmp_path / "store"),
         str(tmp_path / f"{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, logs[r][-2000:]) for r, p in enumerate(procs) if p.returncode]
    assert not bad, bad
    x = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    mesh = LocalMesh((2, 2), ("data", "model"), "cpu")
    specs = {"dm": P("data", "model"), "both": P(None, ("model", "data")), "rep": P()}
    for r in range(4):
        res = torch.load(tmp_path / f"{r}.pt")
        for name, spec in specs.items():
            blocks, whole = res[name]
            assert [b is None for b in blocks] == [q != r for q in range(4)]
            assert torch.equal(blocks[r], x[_slice_of(mesh, r, spec, x.shape)])
            assert torch.equal(whole, x)
