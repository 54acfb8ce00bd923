"""HammingMesh topology and comparison topologies (paper §III, Table II, App. C/E);
a copy of ``repro.core.topology``.

Pure-Python analytic models: structure (switch / cable counts), capital cost,
bisection fraction, and diameter for

  * HammingMesh (HxMesh) with ``a x b`` boards and ``x x y`` global dims,
  * nonblocking / tapered fat trees,
  * canonical Dragonfly,
  * 2D HyperX (== Hx1Mesh),
  * 2D torus built from 2x2 boards.

Prices are the paper's (colfaxdirect, April 2022): 64-port switch $14,280,
20 m AoC $603, 5 m DAC $272 (Appendix E).
"""

from __future__ import annotations

import dataclasses
import math

SWITCH_PORTS = 64
SWITCH_COST = 14_280.0
AOC_COST = 603.0
DAC_COST = 272.0


@dataclasses.dataclass(frozen=True)
class TopologyCost:
    """Structure summary of one network build-out."""

    name: str
    num_accelerators: int
    num_switches: int
    num_dac: int
    num_aoc: int
    diameter: int
    bisection_fraction: float  # bisection BW / total injection BW

    @property
    def cost(self) -> float:
        return (
            self.num_switches * SWITCH_COST
            + self.num_dac * DAC_COST
            + self.num_aoc * AOC_COST
        )

    @property
    def cost_musd(self) -> float:
        return self.cost / 1e6


def _fat_tree_diameter(endpoints: int, ports: int = SWITCH_PORTS) -> int:
    """Diameter (in cables, endpoint cables included) of a full-bw fat tree."""
    if endpoints <= ports:
        return 2  # single switch
    # two cables to/from endpoints + 2 per extra level (paper §III-B)
    levels = math.ceil(math.log(endpoints / ports, ports // 2)) + 1
    return 2 * levels


# ---------------------------------------------------------------------------
# HammingMesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HxMesh:
    """An ``x × y`` HxMesh of ``a × b`` boards with ``planes`` planes.

    Each accelerator has 4 ports per plane (E/W/N/S); accelerators forward
    packets within a plane only (4x4 switches in the endpoints).
    """

    a: int
    b: int
    x: int
    y: int
    planes: int = 4
    taper: float = 1.0  # global-topology tapering factor (1.0 = full bw)

    @property
    def name(self) -> str:
        return f"{self.x}x{self.y} Hx{self.a}x{self.b}Mesh"

    @property
    def num_accelerators(self) -> int:
        return self.a * self.b * self.x * self.y

    @property
    def num_boards(self) -> int:
        return self.x * self.y

    # -- bandwidth ---------------------------------------------------------

    @property
    def bisection_fraction(self) -> float:
        """Relative bisection bandwidth 1/(2a) (paper §III-A, square board)."""
        # cut the 2a links in y direction of each lower-half board:
        # cut width a*x*y vs per-partition injection 2*x*y*a^2
        return self.taper / (2 * self.a)

    # -- diameter ----------------------------------------------------------

    def global_tree_endpoints(self, dim: int) -> int:
        """Endpoints of the per-row / per-column global tree (2x or 2y)."""
        return 2 * (self.x if dim == 0 else self.y)

    @property
    def diameter(self) -> int:
        """Paper §III-B: board hops + two global-topology traversals."""
        board = 2 * ((self.a - 1) // 2 + (self.b - 1) // 2)
        tree_x = _fat_tree_diameter(self.global_tree_endpoints(0))
        tree_y = _fat_tree_diameter(self.global_tree_endpoints(1))
        return board + tree_x + tree_y

    # -- structure / cost (Appendix C) --------------------------------------

    def _tree_build(self, endpoints: int) -> tuple[int, int]:
        """(#switches, #inter-switch AoC cables) for one full-bw global tree."""
        if endpoints <= SWITCH_PORTS:
            return 1, 0
        # two-level fat tree: L1 switches each give half ports down/up.
        l1 = math.ceil(endpoints / (SWITCH_PORTS // 2))
        l2 = math.ceil(l1 * (SWITCH_PORTS // 2) / SWITCH_PORTS)
        aoc = l1 * (SWITCH_PORTS // 2)  # L1<->L2 links
        return l1 + l2, aoc

    def _dim_trees(self, boards: int, rows: int) -> tuple[int, int, int]:
        """Global trees along one dimension (Appendix C).

        Each on-board row exposes 2 links (E+W) per plane to ``boards`` boards
        → 2*boards endpoints per row tree.  When several on-board rows fit a
        single 64-port switch they are merged (the paper's small-cluster
        layout); otherwise each row gets its own (fat) tree.

        Returns (#trees, #switches, #inter-switch AoC) per plane per line of
        boards; caller multiplies endpoint cables.
        """
        per_row = 2 * boards
        group = max(1, min(rows, SWITCH_PORTS // per_row))
        n_trees = math.ceil(rows / group)
        sw, tree_aoc = self._tree_build(group * per_row)
        return n_trees, sw, tree_aoc

    def structure(self) -> TopologyCost:
        switches = 0
        dac = 0
        aoc = 0
        # x dimension: y lines of boards; b on-board rows each.
        n_trees, sw, tree_aoc = self._dim_trees(self.x, self.b)
        switches += self.y * n_trees * sw
        dac += 2 * self.x * self.b * self.y  # endpoint cables (DAC this dim)
        aoc += self.y * n_trees * tree_aoc
        # y dimension: x lines of boards; a on-board columns each (AoC).
        n_trees, sw, tree_aoc = self._dim_trees(self.y, self.a)
        switches += self.x * n_trees * sw
        aoc += 2 * self.y * self.a * self.x + self.x * n_trees * tree_aoc
        return TopologyCost(
            name=self.name,
            num_accelerators=self.num_accelerators,
            num_switches=switches * self.planes,
            num_dac=dac * self.planes,
            num_aoc=aoc * self.planes,
            diameter=self.diameter,
            bisection_fraction=self.bisection_fraction,
        )


# ---------------------------------------------------------------------------
# Fat trees
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FatTree:
    """Fat tree with per-plane single-port endpoints (16 planes).

    ``taper``: fraction of bandwidth removed at the first level
    (0.0 nonblocking, 0.5, 0.75).
    """

    num_accelerators: int
    taper: float = 0.0
    planes: int = 16

    @property
    def name(self) -> str:
        if self.taper == 0.0:
            return f"nonblocking FT ({self.num_accelerators})"
        return f"{int(self.taper * 100)}% tapered FT ({self.num_accelerators})"

    @property
    def global_fraction(self) -> float:
        return 1.0 - self.taper

    def structure(self) -> TopologyCost:
        n = self.num_accelerators
        p = SWITCH_PORTS
        if self.taper == 0.0:
            if n <= p * p // 2:  # two levels
                l1 = math.ceil(n / (p // 2))
                l2 = math.ceil(l1 // 2)
                switches, dac, aoc = l1 + l2, n, n
                diameter = 4
            else:  # three levels (large cluster: 512+512+256 for 16,384)
                l1 = math.ceil(n / (p // 2))
                l2 = l1
                l3 = l1 // 2
                switches, dac, aoc = l1 + l2 + l3, n, 2 * n
                diameter = 6
        else:
            # Appendix C: taper at the first level only. 50% → 42 down/22 up,
            # 75% → 51 down/13 up per L1 switch.
            down = int(p / (2 - self.taper))
            up = p - down
            l1 = math.ceil(n / down)
            uplinks = l1 * up
            if uplinks <= p * p // 2:  # small cluster: single level above
                l2 = math.ceil(uplinks / p)
                switches = l1 + l2
                dac = l1 * down
                aoc = uplinks
                diameter = 4
            else:  # large cluster: nonblocking 2-level tree above L1
                l2 = math.ceil(uplinks / (p // 2))
                l3 = math.ceil(l2 * (p // 2) / p)
                switches = l1 + l2 + l3
                dac = l1 * down
                aoc = uplinks + l2 * (p // 2)
                diameter = 6
        return TopologyCost(
            name=self.name,
            num_accelerators=n,
            num_switches=switches * self.planes,
            num_dac=dac * self.planes,
            num_aoc=aoc * self.planes,
            diameter=diameter,
            bisection_fraction=self.global_fraction,
        )


# ---------------------------------------------------------------------------
# Dragonfly (canonical, Kim et al.)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Dragonfly:
    """Canonical Dragonfly a=2p=2h mapped into 64-port physical switches."""

    a: int  # routers per group (virtual switches)
    p: int  # terminals per router
    h: int  # global links per router
    groups: int
    planes: int = 16

    @property
    def name(self) -> str:
        return f"Dragonfly a={self.a},p={self.p},h={self.h},g={self.groups}"

    @property
    def num_accelerators(self) -> int:
        return self.a * self.p * self.groups

    def structure(self) -> TopologyCost:
        # ports needed per virtual router; pack 2 per 64-port switch if they fit
        ports = (self.a - 1) + self.p + self.h
        routers_per_phys = 2 if 2 * ports <= SWITCH_PORTS + 2 else 1
        phys_per_group = self.a // routers_per_phys
        switches = phys_per_group * self.groups
        # global AoC: each group has a*h links, each cable serves two groups
        aoc = self.groups * self.a * self.h // 2
        if routers_per_phys == 2:
            # per physical switch: 2 virtual routers with a-2 external local
            # links each (one internal), halved for sharing + 2p terminals
            dac = switches * (2 * (self.a - 2) // 2 + 2 * self.p)
        else:
            # terminals + intra-group router-router mesh (App. C large DF)
            dac = self.groups * (self.p * self.a + self.a * (self.a - 1) // 2)
        # diameter: 3 when every router pair in two groups has a direct global
        # link (small dense config), else terminal-local-global-local-terminal.
        dense = self.a * self.h / max(1, self.groups - 1) >= self.a
        return TopologyCost(
            name=self.name,
            num_accelerators=self.num_accelerators,
            num_switches=switches * self.planes,
            num_dac=dac * self.planes,
            num_aoc=aoc * self.planes,
            diameter=3 if dense else 5,
            bisection_fraction=1.0,
        )


# ---------------------------------------------------------------------------
# 2D HyperX (== Hx1Mesh) and 2D torus
# ---------------------------------------------------------------------------


def hyperx(x: int, y: int, planes: int = 4) -> HxMesh:
    """2D HyperX is an Hx1Mesh (paper footnote 2)."""
    return HxMesh(a=1, b=1, x=x, y=y, planes=planes)


@dataclasses.dataclass(frozen=True)
class Torus2D:
    """2D torus of 2x2 boards (paper's comparison torus).

    Inter-board cables are charged at AoC prices (wraparound + rack-to-rack
    distances; this calibrates to Table II's $2.5M / $39.5M).
    """

    boards_x: int
    boards_y: int
    board: int = 2
    planes: int = 4

    @property
    def name(self) -> str:
        side_x = self.boards_x * self.board
        side_y = self.boards_y * self.board
        return f"2D torus {side_x}x{side_y}"

    @property
    def num_accelerators(self) -> int:
        return (self.boards_x * self.boards_y) * self.board * self.board

    def structure(self) -> TopologyCost:
        # per plane: each board has `board` links per edge; 2 dims; each cable
        # shared between two boards: 2 dims * board * boards (torus wraps).
        cables = 2 * self.board * self.boards_x * self.boards_y
        side_x = self.boards_x * self.board
        side_y = self.boards_y * self.board
        # bisection: cut one dimension: 2 * side * link / injection
        shorter = min(side_x, side_y)
        bisect = (2 * shorter * 2) / (4 * self.num_accelerators)
        return TopologyCost(
            name=self.name,
            num_accelerators=self.num_accelerators,
            num_switches=0,
            num_dac=0,
            num_aoc=cables * self.planes,
            diameter=side_x // 2 + side_y // 2,
            bisection_fraction=bisect,
        )


# ---------------------------------------------------------------------------
# Paper's example clusters (Table II rows)
# ---------------------------------------------------------------------------


def small_cluster() -> dict[str, TopologyCost]:
    """~1,000-accelerator cluster configurations (Table II left)."""
    return {
        "nonbl. FT": FatTree(1024, 0.0).structure(),
        "50% tap. FT": FatTree(1050, 0.5).structure(),
        "75% tap. FT": FatTree(1071, 0.75).structure(),
        "Dragonfly": Dragonfly(a=16, p=8, h=8, groups=8).structure(),
        "2D HyperX": hyperx(32, 32).structure(),
        "Hx2Mesh": HxMesh(2, 2, 16, 16).structure(),
        "Hx4Mesh": HxMesh(4, 4, 8, 8).structure(),
        "2D torus": Torus2D(16, 16).structure(),
    }


def large_cluster() -> dict[str, TopologyCost]:
    """~16,000-accelerator cluster configurations (Table II right)."""
    return {
        "nonbl. FT": FatTree(16384, 0.0).structure(),
        "50% tap. FT": FatTree(16380, 0.5).structure(),
        "75% tap. FT": FatTree(16422, 0.75).structure(),
        "Dragonfly": Dragonfly(a=32, p=17, h=16, groups=30).structure(),
        "2D HyperX": hyperx(128, 128).structure(),
        "Hx2Mesh": HxMesh(2, 2, 64, 64).structure(),
        "Hx4Mesh": HxMesh(4, 4, 32, 32).structure(),
        "2D torus": Torus2D(64, 64).structure(),
    }


# Paper's Table II published costs (M$) for validation.
PAPER_COSTS_SMALL = {
    "nonbl. FT": 25.3,
    "50% tap. FT": 17.6,
    "75% tap. FT": 13.2,
    "Dragonfly": 27.9,
    "2D HyperX": 10.8,
    "Hx2Mesh": 5.4,
    "Hx4Mesh": 2.7,
    "2D torus": 2.5,
}

PAPER_COSTS_LARGE = {
    "nonbl. FT": 680.0,
    "50% tap. FT": 419.0,
    "75% tap. FT": 271.0,
    "Dragonfly": 429.0,
    "2D HyperX": 448.0,
    "Hx2Mesh": 224.0,
    "Hx4Mesh": 43.3,
    "2D torus": 39.5,
}

PAPER_DIAMETERS_SMALL = {
    "nonbl. FT": 4, "50% tap. FT": 4, "75% tap. FT": 4, "Dragonfly": 3,
    "2D HyperX": 4, "Hx2Mesh": 4, "Hx4Mesh": 8, "2D torus": 32,
}

PAPER_DIAMETERS_LARGE = {
    "nonbl. FT": 6, "50% tap. FT": 6, "75% tap. FT": 6, "Dragonfly": 5,
    "2D HyperX": 8, "Hx2Mesh": 8, "Hx4Mesh": 8, "2D torus": 128,
}
