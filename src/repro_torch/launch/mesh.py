"""Meshes for the port's gradient-sync modes (counterpart of ``repro.launch.mesh``).

``make_test_mesh`` builds a ``LocalMesh``: the ranks are threads of this
process.  The production meshes (16 × 16 and 2 × 16 × 16, one rank a device
across hosts) come with the mesh and sharding slice (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import torch

from repro_torch.core.comm import LocalMesh
from repro_torch.device import resolve_device


def local_devices(device=None) -> list[torch.device]:
    """This process's devices of ``device``'s type: every visible GPU, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_test_mesh(shape=(4, 4), axes=("data", "model"), device=None) -> LocalMesh:
    """A mesh of ``shape`` with every rank on ``device`` (the GPU by default):
    the counterpart of the JAX package's mesh over fake CPU devices."""
    return LocalMesh(shape, axes, resolve_device(device))
