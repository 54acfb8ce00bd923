"""Sharded checkpoint/restart with elastic resharding, in the JAX package's format
(counterpart of ``repro.checkpoint``).

Format: one ``leaf_%05d.npy`` per leaf of the state tree, numbered in
``jax.tree.flatten``'s order (``repro_torch.tree``), with bfloat16 stored as
a uint16 view, and a ``manifest.json`` holding ``step``, ``n_leaves``,
``dtypes``, ``treedef`` (informational) and ``extra``.  A checkpoint written
by either package restores in the other.  Leaves go through host memory: a
sharded leaf (``parallel.sharding.Sharded``) is saved as its global tensor,
put back together from its blocks, as JAX's ``np.asarray`` gathers a sharded
array (on a ``DistMesh`` that gather is collective: every process calls
``save``).  ``restore`` puts each leaf on the device of the target's leaf, or,
given a tree of ``NamedSharding``s, cuts it into the blocks of that
sharding's mesh, which need not be the mesh it was saved from (elastic
scaling: the paper's checkpoint, reallocate and restart of §IV-A-b).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.parallel.sharding import Sharded

MANIFEST = "manifest.json"


def _leaf_path(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _to_numpy(x) -> tuple[np.ndarray, str]:
    t = x.gather() if isinstance(x, Sharded) else x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(directory: str, state, step: int, extra: dict | None = None) -> None:
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, structure = tree_lib.flatten(state)
    dtypes = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, _leaf_path(i)), arr)
        dtypes.append(dtype)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "dtypes": dtypes,
        "treedef": tree_lib.describe(structure),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.replace(tmp, directory)  # atomic-ish publish


def restore(directory: str, target_state, shardings=None):
    """Load into the structure of ``target_state`` -> (state, step).

    The target gives the tree structure, each leaf's shape (checked) and its
    device; the dtype is the stored one, as in the JAX version.
    ``shardings``: an optional tree of ``parallel.sharding.NamedSharding`` of
    the target's structure (elastic resharding); each leaf then comes back as
    a ``Sharded`` cut for that sharding's mesh.
    """
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    leaves, structure = tree_lib.flatten(target_state)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, target {len(leaves)}")
    shard_leaves = ([None] * len(leaves) if shardings is None
                    else tree_lib.leaves(shardings))
    if len(shard_leaves) != len(leaves):
        raise ValueError(f"{len(shard_leaves)} shardings for {len(leaves)} leaves")
    out = []
    for i, (ref, shard) in enumerate(zip(leaves, shard_leaves)):
        arr = np.load(os.path.join(directory, _leaf_path(i)))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: {arr.shape} != {tuple(ref.shape)}")
        if shard is not None:
            out.append(shard.put(_from_numpy(arr, manifest["dtypes"][i], "cpu")))
        else:
            out.append(_from_numpy(arr, manifest["dtypes"][i], ref.device))
    return tree_lib.unflatten(structure, out), manifest["step"]


def latest_step(base_dir: str) -> int | None:
    """Scan ``base_dir`` for step_<N> checkpoints; return max N."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for name in os.listdir(base_dir):
        if name.startswith("step_") and os.path.isdir(os.path.join(base_dir, name)):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def save_step(base_dir: str, state, step: int, keep: int = 3) -> None:
    save(os.path.join(base_dir, f"step_{step}"), state, step)
    # retention
    steps = sorted(
        int(n.split("_", 1)[1])
        for n in os.listdir(base_dir)
        if n.startswith("step_")
    )
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(base_dir, f"step_{old}"), ignore_errors=True)


def restore_latest(base_dir: str, target_state, shardings=None):
    step = latest_step(base_dir)
    if step is None:
        return None, None
    return restore(os.path.join(base_dir, f"step_{step}"), target_state, shardings)
