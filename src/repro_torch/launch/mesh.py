"""Mesh construction (counterpart of ``repro.launch.mesh``).

Single pod: 16 × 16 = 256 ranks, axes ("data", "model").
Multi-pod:  2 × 16 × 16 = 512 ranks, axes ("pod", "data", "model").

``make_production_mesh`` is a ``DistMesh`` under a process group of that many
ranks, one rank a process (a GPU each under NCCL), or, with an explicit
``device``, a ``LocalMesh`` of that many rank threads on it: the counterpart
of the JAX dry-run's placeholder host devices, for code that needs the mesh's
shape and layout (the spec functions of ``parallel/sharding.py``).
``make_test_mesh`` builds a small ``LocalMesh``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.comm import DistMesh, LocalMesh
from repro_torch.device import resolve_device


def local_devices(device=None) -> list[torch.device]:
    """This process's devices of ``device``'s type: every visible GPU, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def production_layout(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's (shape, axis names), for ``make_production_mesh``
    and the dry-run's ``TraceMesh``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape, axes = production_layout(multi_pod)
    n = math.prod(shape)
    if device is not None:
        return LocalMesh(shape, axes, resolve_device(device))
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"the production mesh needs {n} ranks, the process group has "
                               f"{dist.get_world_size()}")
        return DistMesh(shape, axes, _process_device())
    raise RuntimeError(
        f"need {n} ranks for the production mesh: run under torchrun with {n} processes, "
        "or pass device= for a mesh of rank threads on one device")


def _process_device() -> torch.device:
    """This process's device in an initialised process group: its GPU under NCCL
    (``torch.cuda.set_device`` picks it), the CPU otherwise."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_test_mesh(shape=(4, 4), axes=("data", "model"), device=None) -> LocalMesh:
    """A mesh of ``shape`` with every rank on ``device`` (the GPU by default):
    the counterpart of the JAX package's mesh over fake CPU devices."""
    return LocalMesh(shape, axes, resolve_device(device))
