"""Edge-disjoint Hamiltonian cycles in a 2D torus (paper §V-A2b, App. D).

The port's copy of ``repro.core.hamiltonian`` (stdlib only; the port imports
nothing of ``repro``), for the dual-Hamiltonian allreduce of
``repro_torch.core.collectives``.

The paper maps two bidirectional pipelined rings onto two *edge-disjoint*
Hamiltonian cycles of the (virtual) 2D torus so that an allreduce can drive
all four per-plane NICs concurrently (Bae, AlBdaiwi & Bose 2004).  The
construction below follows the same decomposition the paper's Listing 1
implements: for an ``r x c`` torus with ``r = k*c`` (k >= 1) and
``gcd(r, c-1) == 1``:

* the **red** cycle traverses each row fully (all horizontal edges except one
  per row) and drops one vertical edge per row with a diagonal column shift,
* the **green** cycle uses exactly the complementary edges: all remaining
  vertical edges plus the one skipped horizontal edge per row.

Both are Hamiltonian and their edge sets are disjoint, so together they use
every torus edge exactly once — i.e. all 4 ports of every accelerator.
"""

from __future__ import annotations

import math


def supports_disjoint_cycles(r: int, c: int) -> bool:
    """Bae et al. conditions for the dual-cycle construction."""
    if r <= 2 or c <= 2:  # a dim-2 torus has doubled (wrap == direct) edges
        return False
    return r % c == 0 and math.gcd(r, c - 1) == 1


def red_cycle(r: int, c: int) -> list[tuple[int, int]]:
    """Row-major diagonal cycle: row i traversed left→right from column -i."""
    if not supports_disjoint_cycles(r, c):
        raise ValueError(f"no disjoint Hamiltonian cycles for {r}x{c}")
    order = []
    for i in range(r):
        start = (-i) % c
        for j in range(c):
            order.append((i, (start + j) % c))
    return order


def green_cycle(r: int, c: int) -> list[tuple[int, int]]:
    """Column-ish cycle on the complementary edge set.

    Rule at (i, j): if the horizontal edge of row i (between columns
    -(i+1) and -i mod c) starts here, take it; otherwise move down.
    """
    if not supports_disjoint_cycles(r, c):
        raise ValueError(f"no disjoint Hamiltonian cycles for {r}x{c}")
    n = r * c
    i, j = 0, 0
    order = [(i, j)]
    for _ in range(n - 1):
        if j == (-(i + 1)) % c:  # red skipped this horizontal edge: use it
            j = (j + 1) % c
        else:
            i = (i + 1) % r
        order.append((i, j))
    return order


def cycle_edges(order: list[tuple[int, int]]) -> set[frozenset]:
    """Undirected edge set of a cyclic vertex order."""
    n = len(order)
    return {frozenset((order[k], order[(k + 1) % n])) for k in range(n)}


def is_hamiltonian_torus_cycle(order: list[tuple[int, int]], r: int, c: int) -> bool:
    """Check ``order`` is a Hamiltonian cycle using only torus edges."""
    if len(order) != r * c or len(set(order)) != r * c:
        return False
    for k in range(len(order)):
        (i0, j0), (i1, j1) = order[k], order[(k + 1) % len(order)]
        di = min((i0 - i1) % r, (i1 - i0) % r)
        dj = min((j0 - j1) % c, (j1 - j0) % c)
        if not ((di == 1 and dj == 0) or (di == 0 and dj == 1)):
            return False
    return True


def single_cycle(r: int, c: int) -> list[tuple[int, int]]:
    """One Hamiltonian cycle for any torus with an even dimension
    (boustrophedon).  Used by the bidirectional-ring allreduce when the dual
    construction's conditions don't hold."""
    if r % 2 == 0:
        # snake down column pairs: traverse columns 1..c-1 in a boustrophedon
        # over all rows, then return up column 0.
        order = []
        for i in range(r):
            cols = range(1, c) if i % 2 == 0 else range(c - 1, 0, -1)
            order.extend((i, j) for j in cols)
        order.extend((i, 0) for i in range(r - 1, -1, -1))
        return order
    if c % 2 == 0:
        return [(i, j) for (j, i) in single_cycle(c, r)]
    raise ValueError(f"no boustrophedon Hamiltonian cycle for odd x odd {r}x{c}")


def dual_cycles(r: int, c: int) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """The two edge-disjoint Hamiltonian cycles, transposing if needed."""
    if supports_disjoint_cycles(r, c):
        return red_cycle(r, c), green_cycle(r, c)
    if supports_disjoint_cycles(c, r):
        red = [(i, j) for (j, i) in red_cycle(c, r)]
        green = [(i, j) for (j, i) in green_cycle(c, r)]
        return red, green
    raise ValueError(f"no disjoint Hamiltonian cycles for {r}x{c} (or transpose)")
