"""Flow-level bandwidth engine of the flow simulator, with a device backend
(copy of the matrix path of ``repro.core.flowsim``).

The JAX package bounds achievable bandwidth with a flow-level model: route
traffic over shortest paths with ideal ECMP (path-count-proportional
splitting) and report ``1 / max_link_load``.  This module keeps its own copy
of the pieces that path needs: ``Network``, the topology builders of one
plane (``build_hxmesh``, ``build_fat_tree``, ``build_torus``), and the NumPy
engine (``shortest_paths``: a level-synchronous BFS, one sparse ``frontier @
A`` a level; ``edge_loads``: a Brandes-style backward sweep, one scatter-add
a level).  Traffic is a dense matrix, or as in the original a sparse
``core.traffic.Demand``, a ``TrafficSpec`` or a traffic token
(``skewed-alltoall:h8:seed3``), whose dense rows ``demand_edge_loads``
materializes one source chunk at a time, so the full ``(n, n)`` matrix never
exists.  The original's symmetry-class fast path for symmetric and bisection
demands is NumPy with no device part and is not copied: every demand runs
the chunked pass over all its sources.

``backend="torch"`` is the counterpart of the original's ``backend="jax"``,
"device execution of the same algorithm": the BFS as dense ``frontier @ A``
(the adjacency built on the device once a call; path counts summed in
float64, which is exact and ignores the TF32 setting, and kept in float32)
and the sweep as a scatter-add (``index_add``) a level in float32, returning
float64 NumPy arrays.  It runs on ``cuda`` unless
``device="cpu"`` is given, and raises without a GPU otherwise.

Graphs model ONE plane (as the paper simulates): every accelerator has 4
links (E/W/N/S) in an HxMesh plane, or 1 uplink in a fat-tree plane.  All
link bandwidths are normalized to 1.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch.device import resolve_device

try:
    import scipy.sparse as _sp
except ImportError:  # pragma: no cover - scipy ships with the toolchain
    _sp = None


@dataclasses.dataclass
class Network:
    """Undirected multigraph with unit-bandwidth links.

    ``adj`` maps node -> neighbor list; parallel links are repeated entries.
    ``meta`` records builder geometry (used by geometry-aware traffic
    patterns and board-level failure injection).
    """

    n_endpoints: int  # endpoints are node ids [0, n_endpoints)
    adj: dict[int, list[int]]  # node -> neighbor list (parallel links allowed)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return max(self.adj) + 1

    def edge_array(self) -> np.ndarray:
        edges = []
        for u, nbrs in self.adj.items():
            for v in nbrs:
                edges.append((u, v))
        return np.array(edges, dtype=np.int64)

    def directed_edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Unique *directed* edges as arrays ``(U, V, M)`` with multiplicity
        ``M`` (each undirected link appears once per direction)."""
        if getattr(self, "_edge_cache", None) is None:
            counts: dict[tuple[int, int], int] = defaultdict(int)
            for u, nbrs in self.adj.items():
                for v in nbrs:
                    counts[(u, v)] += 1
            if counts:
                uv = np.array(sorted(counts), dtype=np.int64)
                m = np.array([counts[(int(a), int(b))] for a, b in uv],
                             dtype=np.float64)
                self._edge_cache = (uv[:, 0], uv[:, 1], m)
            else:
                z = np.zeros(0, dtype=np.int64)
                self._edge_cache = (z, z, np.zeros(0))
        return self._edge_cache

    def csr_adjacency(self):
        """Multiplicity-weighted adjacency as a scipy CSR matrix (or ``None``
        when scipy is unavailable — the engine falls back to scatter-adds)."""
        if _sp is None:
            return None
        if getattr(self, "_csr_cache", None) is None:
            u, v, m = self.directed_edges()
            n = self.n_nodes
            self._csr_cache = _sp.csr_matrix((m, (u, v)), shape=(n, n))
        return self._csr_cache

    def active_endpoints(self) -> np.ndarray:
        """Endpoints that still have at least one link (failures isolate
        nodes rather than renumbering them)."""
        return np.array(
            [e for e in range(self.n_endpoints) if self.adj.get(e)],
            dtype=np.int64,
        )




def shortest_paths(
    net: Network, sources=None, backend: str = "numpy", device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Batched BFS distances and shortest-path counts.

    Returns ``(D, Np)`` of shape ``(len(sources), n_nodes)`` — ``D`` is -1
    where unreachable.  One sparse ``frontier @ A`` per distance level
    replaces the per-source Python BFS of the oracle.
    """
    srcs = np.asarray(
        sources if sources is not None else np.arange(net.n_endpoints),
        dtype=np.int64,
    )
    if backend == "torch":
        return _shortest_paths_torch(net, srcs, device)
    n = net.n_nodes
    s = len(srcs)
    A = net.csr_adjacency()
    U, V, M = net.directed_edges()
    D = np.full((s, n), -1, dtype=np.int32)
    Np = np.zeros((s, n), dtype=np.float64)
    rows = np.arange(s)
    D[rows, srcs] = 0
    Np[rows, srcs] = 1.0
    frontier = np.zeros((s, n), dtype=np.float64)
    frontier[rows, srcs] = 1.0
    d = 0
    while True:
        if A is not None:
            nxt = np.asarray(frontier @ A)
        else:  # scatter-add fallback (no scipy)
            nxt = np.zeros_like(frontier)
            np.add.at(nxt.T, V, (frontier[:, U] * M).T)
        new = (D == -1) & (nxt > 0)
        if not new.any():
            break
        d += 1
        D[new] = d
        Np[new] = nxt[new]
        frontier = np.where(new, nxt, 0.0)
    return D, Np




def edge_loads(
    net: Network,
    traffic: np.ndarray,
    sources=None,
    source_chunk: int = 512,
    backend: str = "numpy",
    device=None,
) -> np.ndarray:
    """Per-link ECMP loads for a dense traffic matrix, batched over sources.

    ``traffic`` is ``(S, n_endpoints)`` demand volumes for the given
    ``sources`` (default: all endpoints, i.e. a full ``(n_e, n_e)`` matrix).
    Returns loads aligned with ``net.directed_edges()`` — the load carried by
    *one* link of each parallel bundle (parallel links split evenly, so the
    bundle max equals the per-link value).
    """
    srcs = np.asarray(
        sources if sources is not None else np.arange(net.n_endpoints),
        dtype=np.int64,
    )
    traffic = np.asarray(traffic, dtype=np.float64)
    assert traffic.shape == (len(srcs), net.n_endpoints), traffic.shape
    U, V, M = net.directed_edges()
    loads = np.zeros(len(U), dtype=np.float64)
    source_chunk = max(1, source_chunk)
    # the torch backend's adjacency, built on the device once for every chunk
    A = _dense_adjacency(net, resolve_device(device)) if backend == "torch" else None
    for lo in range(0, len(srcs), source_chunk):
        hi = min(lo + source_chunk, len(srcs))
        loads += _edge_loads_chunk(
            net, srcs[lo:hi], traffic[lo:hi], U, V, M, backend, device, A
        )
    return loads




def _edge_loads_chunk(net, srcs, T, U, V, M, backend, device=None, A=None):
    if backend == "torch":
        return _edge_loads_chunk_torch(net, srcs, T, U, V, M, device, A)
    if backend != "numpy":
        raise ValueError(f"unknown backend {backend!r}: numpy or torch")
    n = net.n_nodes
    s = len(srcs)
    D, Np = shortest_paths(net, srcs)
    # φ init: per-destination demand / total path count (0 where unreachable
    # or self-traffic; endpoints only — switches have no demand).
    vol = np.zeros((s, n), dtype=np.float64)
    vol[:, : net.n_endpoints] = T
    vol[np.arange(s), srcs] = 0.0
    reach = (D >= 0) & (Np > 0)
    phi = np.where(reach, vol / np.where(Np == 0.0, 1.0, Np), 0.0)
    # Backward sweep over distance levels (deepest first).  Group the
    # (source, downhill-edge) pairs by the source-side level once, then each
    # level is one scatter-add — no per-level full-mask rescans.
    DU = D[:, U]
    downhill = (D[:, V] == DU + 1) & (DU >= 0)
    si, ei = np.nonzero(downhill)
    if len(si):
        lev = DU[si, ei]
        order = np.argsort(lev, kind="stable")
        si, ei, lev = si[order], ei[order], lev[order]
        bounds = np.searchsorted(lev, np.arange(int(lev[-1]) + 2))
        for d in range(int(lev[-1]), -1, -1):
            a, b = bounds[d], bounds[d + 1]
            if a == b:
                continue
            np.add.at(
                phi,
                (si[a:b], U[ei[a:b]]),
                M[ei[a:b]] * phi[si[a:b], V[ei[a:b]]],
            )
    # Per-link load of edge (u,v): Σ_s Np[s,u]·φ_s(v) over downhill pairs.
    return np.einsum("se,se->e", Np[:, U] * downhill, phi[:, V])


def max_link_load(net: Network, traffic, sources=None, source_chunk: int = 512,
                  backend: str = "numpy", device=None) -> float:
    """Max per-link load.  ``traffic`` may be a sparse ``traffic.Demand``, a
    ``traffic.TrafficSpec`` or a traffic token (bound to ``net`` first), which
    take ``demand_max_link_load``; or a dense matrix, ``(S, n_endpoints)`` for
    the given ``sources`` or the full ``(n_endpoints, n_endpoints)``."""
    dem = _as_demand(net, traffic)
    if dem is not None:
        return demand_max_link_load(net, dem, source_chunk, backend, device)
    traffic = np.asarray(traffic, dtype=np.float64)
    if sources is None and traffic.shape[0] != net.n_endpoints:
        raise ValueError(f"traffic has {traffic.shape[0]} rows for {net.n_endpoints} "
                         "endpoints and no sources")
    loads = edge_loads(net, traffic, sources, source_chunk, backend, device)
    return float(loads.max()) if len(loads) else 0.0


def _as_demand(net: Network, traffic):
    """A ``Demand`` of ``traffic`` bound to ``net`` where it is one, a spec or a
    token; else None (a dense matrix)."""
    from repro_torch.core import traffic as TR  # lazy: traffic imports flowsim

    if isinstance(traffic, TR.Demand):
        return traffic
    if isinstance(traffic, (TR.TrafficSpec, str)):
        return TR.parse_traffic(traffic).demand(net)
    return None


def demand_edge_loads(net: Network, demand, source_chunk: int = 512, backend: str = "numpy",
                      device=None) -> np.ndarray:
    """Per-link ECMP loads of a sparse ``Demand``, its dense rows materialized one
    source chunk at a time: peak memory O(chunk x n), however large the fabric.
    Loads aligned with ``net.directed_edges()``, as ``edge_loads``'."""
    U, V, M = net.directed_edges()
    loads = np.zeros(len(U), dtype=np.float64)
    source_chunk = max(1, source_chunk)
    # the torch backend's adjacency, built on the device once for every chunk
    A = _dense_adjacency(net, resolve_device(device)) if backend == "torch" else None
    for lo in range(0, demand.n_sources, source_chunk):
        hi = min(lo + source_chunk, demand.n_sources)
        loads += _edge_loads_chunk(net, demand.sources[lo:hi], demand.rows(lo, hi), U, V, M,
                                   backend, device, A)
    return loads


def demand_max_link_load(net: Network, demand, source_chunk: int = 512, backend: str = "numpy",
                         device=None) -> float:
    """Max per-link load of a ``Demand``: the chunked pass over every source
    (``demand_edge_loads``), where the original takes its symmetry-class fast
    path for symmetric and bisection demands (the same loads)."""
    if demand.n_sources == 0:
        return 0.0
    loads = demand_edge_loads(net, demand, source_chunk, backend, device)
    return float(loads.max()) if len(loads) else 0.0


def alltoall_matrix(net: Network) -> np.ndarray:
    """Uniform all-to-all: every active endpoint spreads unit volume over the
    other active endpoints (the original's ``alltoall`` traffic, dense)."""
    act = net.active_endpoints()
    T = np.zeros((net.n_endpoints, net.n_endpoints), dtype=np.float64)
    if len(act) >= 2:
        T[np.ix_(act, act)] = 1.0 / (len(act) - 1)
        T[act, act] = 0.0
    return T


# ---------------------------------------------------------------------------
# Torch backend (device execution of the same algorithm)
# ---------------------------------------------------------------------------


def _dense_adjacency(net: Network, dev: torch.device) -> torch.Tensor:
    """(n, n) float64 link multiplicities, built on ``dev``."""
    u, v, m = (torch.from_numpy(np.asarray(t, dtype=dt)).to(dev)
               for t, dt in zip(net.directed_edges(), (np.int64, np.int64, np.float64)))
    A = torch.zeros((net.n_nodes, net.n_nodes), dtype=torch.float64, device=dev)
    A[u, v] = m
    return A


def _bfs_torch(A: torch.Tensor, srcs: np.ndarray):
    """(D, Np) on ``A``'s device: int32 distances (-1 unreachable) and float32
    path counts.  The counts are summed in float64: integers, exact, and
    untouched by the process-wide TF32 setting that a float32 matmul obeys."""
    dev = A.device
    s, n = len(srcs), A.shape[0]
    rows = torch.arange(s, device=dev)
    src = torch.from_numpy(np.asarray(srcs, dtype=np.int64)).to(dev)
    D = torch.full((s, n), -1, dtype=torch.int32, device=dev)
    D[rows, src] = 0
    Np = torch.zeros((s, n), dtype=torch.float32, device=dev)
    Np[rows, src] = 1.0
    frontier = Np.double()
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    d = 0
    while True:
        nxt = frontier @ A
        new = (D == -1) & (nxt > 0)
        if not bool(new.any()):
            break
        d += 1
        D = torch.where(new, d, D)
        Np = torch.where(new, nxt.float(), Np)
        frontier = torch.where(new, nxt, zero)
    return D, Np


def _shortest_paths_torch(net: Network, srcs: np.ndarray, device=None):
    D, Np = _bfs_torch(_dense_adjacency(net, resolve_device(device)), srcs)
    return D.cpu().numpy(), Np.cpu().double().numpy()


def _edge_loads_chunk_torch(net, srcs, T, U, V, M, device=None, A=None):
    """One chunk of sources; ``A`` is the device's adjacency, when the caller
    has built it already."""
    dev = resolve_device(device)
    n, s = net.n_nodes, len(srcs)
    D, Np = _bfs_torch(_dense_adjacency(net, dev) if A is None else A, srcs)
    rows = torch.arange(s, device=dev)
    vol = torch.zeros((s, n), dtype=torch.float32, device=dev)
    vol[:, : net.n_endpoints] = torch.as_tensor(np.asarray(T), dtype=torch.float32).to(dev)
    vol[rows, torch.from_numpy(np.asarray(srcs, dtype=np.int64)).to(dev)] = 0.0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    reach = (D >= 0) & (Np > 0)
    phi = torch.where(reach, vol / torch.where(Np == 0.0, 1.0, Np), zero)
    Ut = torch.from_numpy(np.asarray(U, dtype=np.int64)).to(dev)
    Vt = torch.from_numpy(np.asarray(V, dtype=np.int64)).to(dev)
    Mt = torch.as_tensor(np.asarray(M), dtype=torch.float32).to(dev)
    DU = D[:, Ut]
    downhill = (D[:, Vt] == DU + 1) & (DU >= 0)
    dmax = int(D.max())
    for d in range(dmax - 1, -1, -1):
        upd = torch.where(downhill & (DU == d), Mt[None, :] * phi[:, Vt], zero)
        phi = phi.index_add(1, Ut, upd)
    loads = ((Np[:, Ut] * downhill) * phi[:, Vt]).sum(dim=0)
    return loads.cpu().double().numpy()


# ---------------------------------------------------------------------------
# Grid geometry (the traffic builders' virtual 2D grid)
# ---------------------------------------------------------------------------


def _grid_geometry(net: Network):
    """(rows, cols, gid) of the virtual 2D grid for mesh-like geometries, or
    ``None``.  ``gid(r, c)`` maps grid coordinates to endpoint ids."""
    meta = net.meta
    if meta.get("kind") == "hxmesh":
        r, c = meta["b"] * meta["y"], meta["a"] * meta["x"]

        def gid(rr, cc):
            by, i = divmod(rr, meta["b"])
            bx, j = divmod(cc, meta["a"])
            return ((by * meta["x"] + bx) * meta["b"] + i) * meta["a"] + j

        return r, c, gid
    if meta.get("kind") == "torus":
        return meta["side_y"], meta["side_x"], (
            lambda rr, cc: rr * meta["side_x"] + cc
        )
    return None


def _squarest_grid(n: int) -> tuple[int, int]:
    r = int(np.sqrt(n))
    while n % r:
        r -= 1
    return r, n // r


def _grid_or_squarest(net: Network, require_square: bool = False):
    """(rows, cols, gid) — the builder grid when the geometry provides one
    (optionally only if square), else the squarest row-major factorization
    of ``n_endpoints``."""
    geo = _grid_geometry(net)
    if geo is not None and (not require_square or geo[0] == geo[1]):
        return geo
    r, c = _squarest_grid(net.n_endpoints)
    return r, c, (lambda rr, cc: rr * c + cc)


# ---------------------------------------------------------------------------
# Topology builders (one plane)
# ---------------------------------------------------------------------------


def build_hxmesh(a: int, b: int, x: int, y: int) -> Network:
    """One plane of an x×y HxMesh of a×b boards.

    Node ids: accelerators 0..N-1 (board-major), then row switches, then
    column switches.  Each on-board row connects E/W to its row switch; each
    on-board column connects N/S to its column switch (single-switch global
    topologies; valid for 2x ≤ 64 as in the small clusters).
    """
    n = a * b * x * y
    adj: dict[int, list[int]] = defaultdict(list)

    def acc(bx: int, by: int, i: int, j: int) -> int:  # board (bx,by), pos (i,j)
        return ((by * x + bx) * b + i) * a + j

    # on-board 2D mesh links
    for by in range(y):
        for bx in range(x):
            for i in range(b):
                for j in range(a):
                    u = acc(bx, by, i, j)
                    if j + 1 < a:
                        v = acc(bx, by, i, j + 1)
                        adj[u].append(v)
                        adj[v].append(u)
                    if i + 1 < b:
                        v = acc(bx, by, i + 1, j)
                        adj[u].append(v)
                        adj[v].append(u)
    # row switches: one per (board-row by, on-board row i)
    row_sw = {}
    nid = n
    for by in range(y):
        for i in range(b):
            row_sw[(by, i)] = nid
            nid += 1
    for by in range(y):
        for bx in range(x):
            for i in range(b):
                sw = row_sw[(by, i)]
                w = acc(bx, by, i, 0)
                e = acc(bx, by, i, a - 1)
                adj[w].append(sw), adj[sw].append(w)
                adj[e].append(sw), adj[sw].append(e)
    # column switches: one per (board-col bx, on-board col j)
    col_sw = {}
    for bx in range(x):
        for j in range(a):
            col_sw[(bx, j)] = nid
            nid += 1
    for by in range(y):
        for bx in range(x):
            for j in range(a):
                sw = col_sw[(bx, j)]
                no = acc(bx, by, 0, j)
                so = acc(bx, by, b - 1, j)
                adj[no].append(sw), adj[sw].append(no)
                adj[so].append(sw), adj[sw].append(so)
    return Network(
        n_endpoints=n, adj=dict(adj),
        meta={"kind": "hxmesh", "a": a, "b": b, "x": x, "y": y,
              "links_per_endpoint": 4},
    )


def build_fat_tree(n: int, taper: float = 0.0, ports: int = 64) -> Network:
    """Two-level fat tree plane (small clusters)."""
    down = int(ports / (2 - taper)) if taper > 0 else ports // 2
    l1 = (n + down - 1) // down
    up = ports - down if taper > 0 else ports // 2
    l2 = max(1, (l1 * up + ports - 1) // ports)
    adj: dict[int, list[int]] = defaultdict(list)
    for e in range(n):
        sw = n + e // down
        adj[e].append(sw), adj[sw].append(e)
    for i in range(l1):
        sw = n + i
        for u in range(up):
            core = n + l1 + (i * up + u) % l2
            adj[sw].append(core), adj[core].append(sw)
    return Network(
        n_endpoints=n, adj=dict(adj),
        meta={"kind": "fat_tree", "taper": taper, "links_per_endpoint": 1},
    )


def build_torus(side_x: int, side_y: int) -> Network:
    """Plain 2D torus plane (1 link per direction per accelerator)."""
    n = side_x * side_y
    adj: dict[int, list[int]] = defaultdict(list)

    def nid(i, j):
        return i * side_x + j

    for i in range(side_y):
        for j in range(side_x):
            u = nid(i, j)
            for v in (nid(i, (j + 1) % side_x), nid((i + 1) % side_y, j)):
                adj[u].append(v)
                adj[v].append(u)
    return Network(
        n_endpoints=n, adj=dict(adj),
        meta={"kind": "torus", "side_x": side_x, "side_y": side_y,
              "links_per_endpoint": 4},
    )
