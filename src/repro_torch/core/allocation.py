"""Board allocation on HammingMesh: the port's copy of what the train driver needs.

A copy of part of ``repro.core.allocation`` (stdlib only; the port imports
nothing of ``repro``): jobs, placements, the paper's greedy allocator with
its transpose and aspect-ratio heuristics, board failure, and the remap of
an evicted job onto a fresh virtual sub-HxMesh (paper §III-E, Fig 5).  An
``x × y`` HxMesh allocates *boards*; a ``u × v`` job takes any ``u`` rows
that share ``v`` common free column indexes.  The policy interface, the
torus and pool allocators and the utilization experiments stay in ``repro``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Iterator


@dataclasses.dataclass
class Job:
    jid: int
    u: int  # rows of boards
    v: int  # columns of boards

    @property
    def size(self) -> int:
        return self.u * self.v


@dataclasses.dataclass
class Placement:
    jid: int
    rows: list[int]
    cols: list[int]

    @property
    def boards(self) -> list[tuple[int, int]]:
        return [(r, c) for r in self.rows for c in self.cols]


class HxMeshAllocator:
    """Tracks free/failed boards of an x × y HxMesh and places jobs."""

    def __init__(self, x: int, y: int):
        self.x = x  # columns
        self.y = y  # rows
        self.free: list[set[int]] = [set(range(x)) for _ in range(y)]
        self.failed: set[tuple[int, int]] = set()
        self.placements: dict[int, Placement] = {}

    def victim_of(self, row: int, col: int) -> int | None:
        """jid of the job whose placement covers board ``(row, col)``."""
        for jid, pl in self.placements.items():
            if row in pl.rows and col in pl.cols:
                return jid
        return None

    def fail_board(self, row: int, col: int) -> int | None:
        """Mark a board failed. Returns the jid of an evicted job, if any."""
        self.failed.add((row, col))
        evicted = self.victim_of(row, col)
        if evicted is not None:
            self.release(evicted)
        self.free[row].discard(col)
        return evicted

    def release(self, jid: int) -> None:
        pl = self.placements.pop(jid)
        for r, c in pl.boards:
            if (r, c) not in self.failed:
                self.free[r].add(c)

    def iter_blocks(self, u: int, v: int) -> Iterator[Placement]:
        """Candidate ``u × v`` virtual sub-HxMeshes, greedily grown from each
        possible first row (the paper's scan order), uncommitted (``jid = -1``).
        The first one is the paper's greedy choice."""
        if u > self.y or v > self.x:
            return
        for first in range(self.y):
            if len(self.free[first]) < v:
                continue
            rows = [first]
            inter = set(self.free[first])
            for nxt in range(first + 1, self.y):
                if len(rows) == u:
                    break
                cand = inter & self.free[nxt]
                if len(cand) >= v:
                    rows.append(nxt)
                    inter = cand
            if len(rows) == u:
                yield Placement(jid=-1, rows=rows, cols=sorted(inter)[:v])

    def commit(self, job: Job, pl: Placement) -> Placement:
        """Commit a candidate placement produced by :meth:`iter_blocks`."""
        pl.jid = job.jid
        for r in pl.rows:
            self.free[r] -= set(pl.cols)
        self.placements[job.jid] = pl
        return pl

    def allocate(self, job: Job, transpose: bool = False, aspect: bool = False,
                 max_aspect: int = 8) -> Placement | None:
        for u, v in job_shapes(job, transpose=transpose, aspect=aspect,
                               max_aspect=max_aspect):
            pl = next(self.iter_blocks(u, v), None)
            if pl is not None:
                return self.commit(job, pl)
        return None


def job_shapes(
    job: Job, transpose: bool = False, aspect: bool = False, max_aspect: int = 8
) -> list[tuple[int, int]]:
    """Candidate ``(u, v)`` board shapes for a job under the §IV-A heuristics
    (requested shape, then transpose, then bounded-aspect-ratio reshapes,
    squarest first)."""
    shapes: list[tuple[int, int]] = [(job.u, job.v)]
    if transpose and job.v != job.u:
        shapes.append((job.v, job.u))
    if aspect:
        size = job.size
        for u in _divisors(size):
            v = size // u
            if max(u, v) / max(1, min(u, v)) <= max_aspect and (u, v) not in shapes:
                shapes.append((u, v))
        # prefer squarest first, as the paper does by default
        shapes.sort(key=lambda s: (max(s) / min(s), s))
    return shapes


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def is_virtual_subhxmesh(boards: Iterable[tuple[int, int]]) -> bool:
    """True iff all boards in the same row share the same column sequence."""
    by_row: dict[int, set[int]] = {}
    for r, c in boards:
        by_row.setdefault(r, set()).add(c)
    cols = None
    for s in by_row.values():
        if cols is None:
            cols = s
        elif s != cols:
            return False
    return cols is not None


def remap_after_failure(
    alloc: HxMeshAllocator, job: Job, **heuristics
) -> Placement | None:
    """Paper Fig 5: find a fresh virtual sub-HxMesh for an evicted job."""
    return alloc.allocate(job, **heuristics)
