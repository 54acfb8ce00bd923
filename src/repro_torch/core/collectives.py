"""HxMesh-aware collective algorithms (paper §V-A2), over a mesh of ranks.

Counterpart of ``repro.core.collectives``.  The paper's allreduce algorithms
move data by neighbour transfers on rings only (``Comm.ppermute``), the
traffic HammingMesh serves at full bandwidth:

* ``ring_allreduce``       — pipelined unidirectional ring, T ≈ 2pα + 2Sβ
* ``bidir_ring_allreduce`` — two half-size rings in opposite directions,
                             T ≈ 2pα + Sβ (§V-A2b)
* ``hamiltonian_allreduce``— two bidirectional rings on *edge-disjoint
                             Hamiltonian cycles* of the 2D mesh, using all
                             four mesh-neighbour links, T ≈ 2pα + S/2·β
* ``torus_allreduce``      — row reduce-scatter → column allreduce → row
                             allgather, T ≈ 4√p·α + Sβ(1+2√p)/(4√p) (§V-A2c)

Each function runs once per rank inside ``Mesh.run`` and takes that rank's
``Comm`` first, where the JAX version runs inside ``shard_map`` and finds
its rank with ``lax.axis_index``.  The rank is a Python int here, and the
chunk it owns, the padding and the order of the transfers are the JAX
version's, so each rank's result holds the same sums, added in the same
order.  ``allreduce_tree`` wraps a gradient tree: flatten in
``jax.tree.flatten``'s order → one fp32 bucket → one collective → unflatten.

Algorithm selection (paper Fig 13) is ``select_algorithm``, from the α-β
models of ``repro_torch.core.commodel``.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import commodel
from repro_torch.core import hamiltonian as ham
from repro_torch.core.comm import Axes, Comm


def _ring_perm(p: int, reverse: bool = False) -> list[tuple[int, int]]:
    if reverse:
        return [(i, (i - 1) % p) for i in range(p)]
    return [(i, (i + 1) % p) for i in range(p)]


def _chunked(x: torch.Tensor, p: int) -> tuple[torch.Tensor, int]:
    """Flatten and pad x to (p, m) chunks."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % p
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(p, -1), pad


def _ring_reduce_scatter(comm: Comm, chunks: torch.Tensor, rank: int, p: int,
                         perm: Sequence[tuple[int, int]], axis: Axes) -> torch.Tensor:
    """Pipelined reduce-scatter along an arbitrary ring.

    ``rank`` is this rank's position in the ring.  Returns the fully reduced
    chunk with index ``(rank + 1) % p``.
    """
    buf = chunks[rank % p]
    for r in range(p - 1):
        buf = comm.ppermute(buf, axis, perm)
        buf = buf + chunks[(rank - r - 1) % p]
    return buf


def _ring_all_gather(comm: Comm, buf: torch.Tensor, rank: int, p: int,
                     perm: Sequence[tuple[int, int]], axis: Axes) -> torch.Tensor:
    """All-gather along a ring; ``buf`` is chunk ``(rank+1) % p``."""
    out = torch.zeros((p,) + tuple(buf.shape), dtype=buf.dtype, device=buf.device)
    out[(rank + 1) % p] = buf
    cur = buf
    for r in range(p - 1):
        cur = comm.ppermute(cur, axis, perm)
        out[(rank - r) % p] = cur  # chunk owned by the (r+1)-hop predecessor
    return out.reshape(-1)


def _ring_allreduce_1d(comm: Comm, x: torch.Tensor, axis: str,
                       reverse: bool = False) -> torch.Tensor:
    p = comm.axis_size(axis)
    rank = comm.axis_index(axis)
    if reverse:
        rank = p - 1 - rank
    perm = _ring_perm(p, reverse)
    chunks, pad = _chunked(x, p)
    buf = _ring_reduce_scatter(comm, chunks, rank, p, perm, axis)
    flat = _ring_all_gather(comm, buf, rank, p, perm, axis)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(x.shape)


# ---------------------------------------------------------------------------
# Public algorithms (inside Mesh.run)
# ---------------------------------------------------------------------------


def ring_allreduce(comm: Comm, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Pipelined unidirectional ring allreduce (paper §V-A2b)."""
    return _ring_allreduce_1d(comm, x, axis)


def ring_reduce_scatter(comm: Comm, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Reduce-scatter returning this rank's chunk (index = axis_index)."""
    p = comm.axis_size(axis)
    rank = comm.axis_index(axis)
    chunks, _ = _chunked(x, p)
    # shift rank so the owned chunk is exactly ``axis_index``
    return _ring_reduce_scatter(comm, chunks, (rank - 1) % p, p, _ring_perm(p), axis)


def ring_all_gather(comm: Comm, x: torch.Tensor, axis: str) -> torch.Tensor:
    """All-gather of per-rank chunks (chunk index = axis_index)."""
    p = comm.axis_size(axis)
    rank = comm.axis_index(axis)
    return _ring_all_gather(comm, x, (rank - 1) % p, p, _ring_perm(p), axis)


def _split_even(x: torch.Tensor, parts: int) -> tuple[list[torch.Tensor], int]:
    """Flatten, pad to a multiple of ``parts`` and split into ``parts`` pieces."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % parts
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return list(flat.chunk(parts)), pad


def _join(pieces: list[torch.Tensor], pad: int, shape) -> torch.Tensor:
    out = torch.cat(pieces)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def bidir_ring_allreduce(comm: Comm, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Bidirectional ring: halves travel in opposite directions (§V-A2b)."""
    (h0, h1), pad = _split_even(x, 2)
    r0 = _ring_allreduce_1d(comm, h0, axis, reverse=False)
    r1 = _ring_allreduce_1d(comm, h1, axis, reverse=True)
    return _join([r0, r1], pad, x.shape)


def _cycle_ring(cycle: list[tuple[int, int]], c: int):
    """(rank table {(i, j): position}, forward pairs, reverse pairs) of a cycle,
    the pairs over the linearised ``i*c + j``."""
    p = len(cycle)
    rank_tbl = {ij: k for k, ij in enumerate(cycle)}
    perm = []
    for k, (i, j) in enumerate(cycle):
        ni, nj = cycle[(k + 1) % p]
        perm.append((i * c + j, ni * c + nj))
    return rank_tbl, perm, [(b, a) for a, b in perm]


def hamiltonian_allreduce(comm: Comm, x: torch.Tensor, axes: tuple[str, str],
                          mesh_shape: tuple[int, int]) -> torch.Tensor:
    """Dual edge-disjoint Hamiltonian-cycle allreduce (§V-A2b, App. D).

    The 2D mesh (axes[0] × axes[1]) is covered by two edge-disjoint
    Hamiltonian cycles (red/green); each carries half the data as a
    bidirectional ring → S/2 bytes per link direction, all four mesh
    directions busy.
    """
    r, c = mesh_shape
    p = r * c
    red, green = ham.dual_cycles(r, c)
    rank_red, perm_red, rperm_red = _cycle_ring(red, c)
    rank_green, perm_green, rperm_green = _cycle_ring(green, c)

    ij = (comm.axis_index(axes[0]), comm.axis_index(axes[1]))
    kr, kg = rank_red[ij], rank_green[ij]

    quarters, pad = _split_even(x, 4)
    outs = []
    for q, rank, perm, reverse in [
        (quarters[0], kr, perm_red, False),
        (quarters[1], kr, rperm_red, True),
        (quarters[2], kg, perm_green, False),
        (quarters[3], kg, rperm_green, True),
    ]:
        rk = (p - 1 - rank) % p if reverse else rank
        chunks, qpad = _chunked(q, p)
        buf = _ring_reduce_scatter(comm, chunks, rk, p, perm, axes)
        full = _ring_all_gather(comm, buf, rk, p, perm, axes)
        if qpad:
            full = full[:-qpad]
        outs.append(full)
    return _join(outs, pad, x.shape)


def torus_allreduce(comm: Comm, x: torch.Tensor, row_axis: str, col_axis: str,
                    dual: bool = True) -> torch.Tensor:
    """2D-torus allreduce (paper §V-A2c).

    reduce-scatter along rows → allreduce along columns → allgather along
    rows.  With ``dual=True``, two transposed instances run on half the data
    each to use all four interfaces (the paper's 4-NIC variant).
    """

    def one(inp: torch.Tensor, ax0: str, ax1: str) -> torch.Tensor:
        p0 = comm.axis_size(ax0)
        rank0 = comm.axis_index(ax0)
        perm0 = _ring_perm(p0)
        chunks, pad0 = _chunked(inp, p0)
        buf = _ring_reduce_scatter(comm, chunks, rank0, p0, perm0, ax0)
        buf = bidir_ring_allreduce(comm, buf, ax1)
        flat = _ring_all_gather(comm, buf, rank0, p0, perm0, ax0)
        if pad0:
            flat = flat[:-pad0]
        return flat

    if not dual:
        return one(x.reshape(-1), row_axis, col_axis).reshape(x.shape)
    (h0, h1), pad = _split_even(x, 2)
    o0 = one(h0, row_axis, col_axis)
    o1 = one(h1, col_axis, row_axis)
    return _join([o0, o1], pad, x.shape)


ALGORITHMS = ("psum", "ring", "bidir", "torus", "hamiltonian")


def allreduce(comm: Comm, x: torch.Tensor, algorithm: str, axes: tuple[str, ...],
              mesh_shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """Dispatch one of the paper's algorithms over 1 or 2 mesh axes."""
    if algorithm == "psum":
        return comm.psum(x, axes)
    if len(axes) == 1:
        if algorithm == "ring":
            return ring_allreduce(comm, x, axes[0])
        if algorithm == "bidir":
            return bidir_ring_allreduce(comm, x, axes[0])
        raise ValueError(f"{algorithm} needs a 2D mesh")
    ax0, ax1 = axes
    if algorithm == "ring":
        # ring over the row axis, then over the column axis (hierarchical)
        return ring_allreduce(comm, ring_allreduce(comm, x, ax0), ax1)
    if algorithm == "bidir":
        return bidir_ring_allreduce(comm, bidir_ring_allreduce(comm, x, ax0), ax1)
    if algorithm == "torus":
        return torus_allreduce(comm, x, ax0, ax1)
    if algorithm == "hamiltonian":
        if mesh_shape is None:
            raise ValueError("hamiltonian needs static mesh_shape")
        return hamiltonian_allreduce(comm, x, (ax0, ax1), mesh_shape)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def select_algorithm(p: int, size_bytes: float) -> str:
    """Multi-algorithm selection from the α-β models (paper Fig 13)."""
    name, _ = commodel.best_algorithm(p, size_bytes)
    return name


# ---------------------------------------------------------------------------
# Gradient-tree wrapper
# ---------------------------------------------------------------------------


def allreduce_tree(comm: Comm, grads, algorithm: str, axes: tuple[str, ...],
                   mesh_shape: tuple[int, ...] | None = None, mean: bool = True):
    """Allreduce a gradient tree: flatten → concat in fp32 → one bucketed
    collective → unflatten, each leaf cast back to its dtype (the paper's
    grouped reduction)."""
    leaves, spec = tree_lib.flatten(grads)
    flat = torch.cat([leaf.reshape(-1).float() for leaf in leaves])
    total = allreduce(comm, flat, algorithm, axes, mesh_shape)
    if mean:
        total = total / comm.axis_size(tuple(axes))
    out, off = [], 0
    for leaf in leaves:
        out.append(total[off:off + leaf.numel()].reshape(leaf.shape).to(leaf.dtype))
        off += leaf.numel()
    return tree_lib.unflatten(spec, out)
