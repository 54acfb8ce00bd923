"""Sharding policy: which mesh axes carry data parallelism.

Counterpart of ``repro.parallel.sharding``'s ``Policy``.  The train step's
gradient-sync modes read ``data_axes`` (the batch is split over them and the
gradients reduced over them).  ``default_policy`` and the parameter, batch
and cache specs come with the mesh and sharding slice (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Policy:
    data_axes: tuple[str, ...] = ("data",)  # ("pod","data") in multi-pod
    model_axis: str = "model"
    fsdp: bool = True
    tp: bool = True

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def fsdp_axis(self):
        return "data" if self.fsdp else None

    @property
    def mp(self):
        return self.model_axis if self.tp else None
