"""Gradient compression for the data-parallel dimension (paper Appendix A).

Counterpart of ``repro.core.compression``: top-k gradient sparsification
with local error feedback (the unsent residual is banked), in the style of
SparCML / Renggli et al.  The sparse reduction is an all-gather of (index,
value) pairs over the data-parallel axis followed by a scatter-add, the
"fill-in tolerant" scheme the paper describes for moderate k.

``sparse_allreduce`` runs once per rank inside ``Mesh.run`` and takes that
rank's ``Comm`` first.  Two differences from JAX that a caller may see:
``lax.top_k`` returns tied magnitudes lower index first and ``torch.topk``
promises no order among them, so only the (index, value) pairs agree, not
their order; and the scatter-add is ``index_add_``, whose float sums of
duplicate indices come in another order on CUDA (atomics).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.comm import Comm


class CompressionState(NamedTuple):
    """Error-feedback residual, one entry per parameter leaf."""

    residual: torch.Tensor


def init_state(grad: torch.Tensor) -> CompressionState:
    return CompressionState(residual=torch.zeros_like(grad))


def topk_compress(grad: torch.Tensor, state: CompressionState, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, CompressionState]:
    """Select the k largest-magnitude entries; bank the rest as residual.

    Returns (values[k], indices[k], new_state).
    """
    flat = grad.reshape(-1) + state.residual.reshape(-1)
    _, idx = torch.topk(flat.abs(), k)
    vals = flat[idx]
    residual = flat.index_fill(0, idx, 0.0)
    return vals, idx, CompressionState(residual=residual.reshape(grad.shape))


def decompress(vals: torch.Tensor, idx: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= int(s)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.reshape(-1), vals.reshape(-1)).reshape(shape)


def sparse_allreduce(comm: Comm, grad: torch.Tensor, state: CompressionState, k: int,
                     axis_name: str) -> tuple[torch.Tensor, CompressionState]:
    """Sparse allreduce over ``axis_name``: the mean over its ranks of their
    top-k entries.

    Communication volume: ``D * k * (4 + itemsize)`` bytes per device instead
    of the dense ``2 * N * itemsize`` ring volume — a win for k << N/D.
    """
    vals, idx, new_state = topk_compress(grad, state, k)
    all_vals = comm.all_gather(vals, axis_name)  # (D, k)
    all_idx = comm.all_gather(idx, axis_name)
    dense = decompress(all_vals, all_idx, (grad.numel(),))
    d = comm.axis_size(axis_name)
    return (dense / d).reshape(grad.shape), new_state


def compression_ratio(n_params: int, k: int, d: int, itemsize: int = 4) -> float:
    """Dense-ring bytes / sparse bytes per device (paper App. A economics)."""
    dense = 2 * n_params * itemsize
    sparse = d * k * (4 + itemsize)
    return dense / sparse
