"""Vectorized flow-level bandwidth simulator with a device backend (a copy of
``repro.core.flowsim``).

The JAX package bounds achievable bandwidth with a flow-level model: route
traffic over shortest paths with ideal ECMP (path-count-proportional
splitting) and report ``1 / max_link_load`` as the achievable fraction of
injection bandwidth (``achievable_fraction``, ``alltoall_fraction``).  This
module keeps its own copy of all of it:

* the NumPy engine: ``shortest_paths``, a level-synchronous BFS, one sparse
  ``frontier @ A`` a level; ``edge_loads``, a Brandes-style backward sweep,
  one scatter-add a level;
* traffic as a dense matrix, the legacy ``(s, t, vol)`` triple list, or a
  sparse ``core.traffic.Demand``, ``TrafficSpec`` or traffic token
  (``skewed-alltoall:h8:seed3``), whose dense rows ``demand_edge_loads``
  materializes one source chunk at a time, so the full ``(n, n)`` matrix never
  exists; the dense shims ``traffic_matrix`` and ``TRAFFIC_PATTERNS``;
* the symmetry-class fast path for symmetric and bisection demands on a
  healthy HxMesh or torus (``symmetric_max_link_load`` over
  ``endpoint_classes`` and ``edge_orbit_ids``): one BFS a class of endpoints,
  not one a source, which makes 16k-65k endpoints tractable;
* the topology builders of one plane (``build_hxmesh``, ``build_fat_tree``,
  ``build_torus``, ``build_dragonfly``) and ``build_network``, the uniform entry
  point from a ``core.topology`` spec, with failures (``fail=boards:1%:seed7``,
  see ``FAILURE_GRAMMAR``), and a job's isolated sub-fabric (``subnetwork``,
  ``placement_endpoints``, ``board_nodes``).

``backend="torch"`` is the counterpart of the original's ``backend="jax"``,
"device execution of the same algorithm": the BFS as dense ``frontier @ A``
(the adjacency built on the device once a call; path counts summed in
float64, which is exact and ignores the TF32 setting, and kept in float32,
exact up to 2**24 paths) and the sweep as a scatter-add (``index_add``) a
level in float32, returning float64 NumPy arrays.  ``device_chunks`` counts
its source chunks.  It runs on ``cuda`` unless ``device="cpu"`` is given,
and raises without a GPU otherwise.  As in the original, the symmetry fast
path runs its representatives through the NumPy engine whatever the backend:
a caller that wants the device pass on a symmetric demand calls
``demand_edge_loads``.

Graphs model ONE plane (as the paper simulates): every accelerator has 4
links (E/W/N/S) in an HxMesh plane, or 1 uplink in a fat-tree plane.  All
link bandwidths are normalized to 1.
"""

from __future__ import annotations

import dataclasses
import re
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
    _check_backend(backend)
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
    """Max per-link load, the engine's headline quantity.  ``traffic`` may be a
    sparse ``traffic.Demand``, a ``traffic.TrafficSpec`` or a traffic token
    (bound to ``net`` first), which take ``demand_max_link_load`` (the symmetry
    fast path where eligible); a dense matrix, ``(S, n_endpoints)`` for the
    given ``sources`` or the full ``(n_endpoints, n_endpoints)``; or the legacy
    ``(s, t, vol)`` triple list."""
    dem = _as_demand(net, traffic)
    if dem is not None:
        return demand_max_link_load(net, dem, source_chunk, backend, device)
    traffic, sources = _coerce_traffic(net, traffic, sources)
    loads = edge_loads(net, traffic, sources, source_chunk, backend, device)
    return float(loads.max()) if len(loads) else 0.0


def achievable_fraction(net: Network, traffic, links_per_endpoint: int = 1,
                        source_chunk: int = 512, backend: str = "numpy",
                        device=None) -> float:
    """Achievable fraction of *injection bandwidth*.

    Traffic volumes are normalized so each source's total demand is 1.  With
    ``L`` unit-bandwidth links per endpoint, injection bandwidth is L, the
    sustainable per-source rate is 1/max_load, and the reported fraction is
    ``1 / (max_load * L)`` (capped at 1).  ``traffic`` is anything
    ``max_link_load`` takes."""
    mx = max_link_load(net, traffic, None, source_chunk, backend, device)
    if mx <= 0:
        return 1.0
    return min(1.0, 1.0 / (mx * links_per_endpoint))


def alltoall_fraction(net: Network, links_per_endpoint: int = 1, source_chunk: int = 512,
                      backend: str = "numpy", device=None) -> float:
    """Exact uniform-alltoall achievable fraction of injection bandwidth."""
    return achievable_fraction(net, "alltoall", links_per_endpoint, source_chunk, backend,
                               device)


def _as_demand(net: Network, traffic):
    """A ``Demand`` of ``traffic`` bound to ``net`` where it is one, a spec or a
    token; else None (a dense matrix or a triple list)."""
    from repro_torch.core import traffic as TR  # lazy: traffic imports flowsim

    if isinstance(traffic, TR.Demand):
        return traffic
    if isinstance(traffic, (TR.TrafficSpec, str)):
        return TR.parse_traffic(traffic).demand(net)
    return None


def _coerce_traffic(net: Network, traffic, sources):
    """``(matrix, sources)`` of a dense ``(S, n_e)`` matrix with its ``sources``,
    a full ``(n_e, n_e)`` matrix, or a legacy ``(s, t, vol)`` triple list (the
    rows of the sources that send, self-traffic dropped)."""
    if isinstance(traffic, np.ndarray):
        if sources is None and traffic.shape[0] != net.n_endpoints:
            raise ValueError(f"traffic has {traffic.shape[0]} rows for {net.n_endpoints} "
                             "endpoints and no sources")
        return traffic, sources
    T = np.zeros((net.n_endpoints, net.n_endpoints), dtype=np.float64)
    for s, t, vol in traffic:
        if s != t:
            T[s, t] += vol
    used = np.nonzero(T.any(axis=1))[0]
    return T[used], used


def _check_backend(backend: str) -> None:
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}: numpy or torch")


def demand_edge_loads(net: Network, demand, source_chunk: int = 512, backend: str = "numpy",
                      device=None) -> np.ndarray:
    """Per-link ECMP loads of a sparse ``Demand``, its dense rows materialized one
    source chunk at a time: peak memory O(chunk x n), however large the fabric.
    Loads aligned with ``net.directed_edges()``, as ``edge_loads``'.  Every
    source runs, symmetric demands too: on ``backend="torch"`` this is the
    device pass."""
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
    """Max per-link load of a ``Demand``: the symmetry-class fast path when the
    demand is symmetric (or a bisection with a ``half_cut``) and the fabric
    declares classes, on the NumPy engine whatever ``backend`` says, as the
    original; else the chunked pass over every source (``demand_edge_loads``)."""
    _check_backend(backend)
    if backend == "torch":
        resolve_device(device)  # raises without a GPU, whichever path runs
    if demand.n_sources == 0:
        return 0.0
    if demand.symmetric or demand.half_cut is not None:
        sym = symmetric_max_link_load(net, demand)
        if sym is not None:
            return sym
    loads = demand_edge_loads(net, demand, source_chunk, backend, device)
    return float(loads.max()) if len(loads) else 0.0


# ---------------------------------------------------------------------------
# Symmetry reduction
# ---------------------------------------------------------------------------


def symmetric_max_link_load(net: Network, demand) -> float | None:
    """Max link load via symmetry reduction, or ``None`` if ineligible.

    For a demand invariant under a subgroup ``H`` of fabric automorphisms
    (declared per builder by ``endpoint_classes`` / ``edge_orbit_ids``), the
    total link load is constant on each H-orbit of directed edges, and for
    any edge orbit ``O`` and source class ``c`` with representative ``r``::

        load(e in O) = sum_c  N_c * (sum_{e' in O} L_r(e')) / |O|

    because ``sum_{e' in O} L_s(e')`` is class-invariant in ``s`` (apply the
    automorphism mapping ``r`` to ``s``; it permutes ``O``).  One BFS a class
    replaces one an endpoint: hx2-64x64 (16,384 endpoints) needs 4
    representatives.  A bisection demand (``demand.half_cut``, the cut's grid
    row) is invariant only under the half-preserving subgroup, which permutes
    board rows within each side of the cut: twice the classes, still exact.
    The representatives run on the NumPy engine.
    """
    if demand.symmetric:
        half_cut = None
    else:
        half_cut = demand.half_cut
        if half_cut is None:
            return None
    classes = endpoint_classes(net, half_cut=half_cut)
    orbits = edge_orbit_ids(net, half_cut=half_cut)
    if classes is None or orbits is None:
        return None
    if len(demand.sources) != net.n_endpoints:
        return None  # the demand must cover every endpoint of the healthy fabric
    U, V, M = net.directed_edges()
    _, rep_idx, counts = np.unique(classes, return_index=True, return_counts=True)
    n_orbits = int(orbits.max()) + 1
    orbit_sizes = np.bincount(orbits, minlength=n_orbits)
    total = np.zeros(n_orbits, dtype=np.float64)
    for rep, n_c in zip(rep_idx, counts):
        rep = int(rep)  # class ids are assigned over endpoints 0..n-1
        L = _edge_loads_chunk(net, np.array([rep], dtype=np.int64), demand.rows_for([rep]),
                              U, V, M, "numpy")
        total += n_c * np.bincount(orbits, weights=L, minlength=n_orbits)
    loads = total / np.maximum(orbit_sizes, 1)
    return float(loads.max()) if len(loads) else 0.0


def endpoint_classes(net: Network, half_cut: int | None = None) -> np.ndarray | None:
    """Endpoint symmetry-class ids under the builder's declared automorphism
    subgroup, or ``None`` (no declared symmetry, or failures applied).

    * ``hxmesh``: permuting board columns and board rows (each global row or
      column tree is a star): endpoints are equivalent iff they share an
      on-board position ``(i, j)``, ``a*b`` classes.
    * ``torus``: translations, one class.

    ``half_cut`` (a grid-row index on a board boundary) restricts to the
    half-preserving subgroup: hxmesh endpoints are then equivalent iff they
    share an on-board position *and* a side (``2*a*b`` classes); the torus
    declares no such subgroup (``None``).  The first endpoint of each class
    (the lowest id) is its representative.
    """
    meta = net.meta
    if meta.get("failures_applied"):
        return None
    kind = meta.get("kind")
    if kind == "hxmesh":
        a, b = meta["a"], meta["b"]
        e = np.arange(net.n_endpoints)
        j = e % a
        i = (e // a) % b
        if half_cut is None:
            return (i * a + j).astype(np.int64)
        if not _hx_half_cut_ok(meta, half_cut):
            return None
        by = e // (a * b * meta["x"])
        side = (by * b + i) >= half_cut
        return (side * (a * b) + i * a + j).astype(np.int64)
    if kind == "torus":
        if half_cut is not None:
            return None
        return np.zeros(net.n_endpoints, dtype=np.int64)
    return None


def edge_orbit_ids(net: Network, half_cut: int | None = None) -> np.ndarray | None:
    """Orbit ids of the directed edges (aligned with ``Network.directed_edges``)
    under the same subgroup as ``endpoint_classes``, or ``None``."""
    meta = net.meta
    if meta.get("failures_applied"):
        return None
    kind = meta.get("kind")
    U, V, _ = net.directed_edges()
    if kind == "hxmesh":
        if half_cut is not None and not _hx_half_cut_ok(meta, half_cut):
            return None
        inv = _hxmesh_node_invariants(net, half_cut)
        keys = [(inv[int(u)], inv[int(v)]) for u, v in zip(U, V)]
    elif kind == "torus":
        if half_cut is not None:
            return None
        sx, sy = meta["side_x"], meta["side_y"]
        iu, ju = U // sx, U % sx
        iv, jv = V // sx, V % sx
        keys = list(zip(((jv - ju) % sx).tolist(), ((iv - iu) % sy).tolist()))
    else:
        return None
    ids: dict[tuple, int] = {}
    return np.array([ids.setdefault(k, len(ids)) for k in keys], dtype=np.int64)


def _hx_half_cut_ok(meta: dict, half_cut: int) -> bool:
    """A half-preserving cut is valid only on a board boundary strictly inside
    the grid: the one rule both ``endpoint_classes`` and ``edge_orbit_ids``
    consult, so that classes and orbits come from the same subgroup."""
    b = meta["b"]
    return half_cut % b == 0 and 0 < half_cut < b * meta["y"]


def _hxmesh_node_invariants(net: Network, half_cut: int | None = None) -> list[tuple]:
    """Per-node invariants under board-row/column permutations: on-board position
    for accelerators, on-board row for row switches, on-board column for column
    switches.  With ``half_cut``, accelerators and row switches also carry the
    side of the cut their grid row is on (column switches span both sides)."""
    a, b, x, y = (net.meta[k] for k in ("a", "b", "x", "y"))
    n = a * b * x * y
    inv: list[tuple] = []
    for v in range(net.n_nodes):
        if v < n:
            i = (v // a) % b
            if half_cut is None:
                inv.append(("a", i, v % a))
            else:
                by = v // (a * b * x)
                inv.append(("a", (by * b + i) >= half_cut, i, v % a))
        elif v < n + y * b:
            if half_cut is None:
                inv.append(("r", (v - n) % b))
            else:
                inv.append(("r", (v - n) >= half_cut, (v - n) % b))
        else:
            inv.append(("c", (v - n - y * b) % a))
    return inv


# ---------------------------------------------------------------------------
# Torch backend (device execution of the same algorithm)
# ---------------------------------------------------------------------------

# Source chunks the torch backend has run since the caller last set this to 0:
# the proof that a call went through the device pass, not the NumPy engine.
device_chunks = 0


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
    global device_chunks
    dev = resolve_device(device)
    device_chunks += 1
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


def build_dragonfly(a: int, p: int, h: int, groups: int) -> Network:
    """Canonical Dragonfly plane (Kim et al.): ``groups`` groups of ``a``
    routers, ``p`` terminals and ``h`` global links per router, complete
    intra-group graph, one-level global wiring.

    Global links per group (``a*h``) must be a multiple of ``groups - 1``;
    the j-th link of pair (g, g') lands on router ``(peer_index*k + j) // h``
    of each side, keeping every router's global degree exactly ``h``.
    """
    if groups > 1:
        assert (a * h) % (groups - 1) == 0, "a*h must divide into group pairs"
    k = (a * h) // (groups - 1) if groups > 1 else 0
    n = a * p * groups
    adj: dict[int, list[int]] = defaultdict(list)

    def router(g: int, r: int) -> int:
        return n + g * a + r

    for g in range(groups):
        for r in range(a):
            sw = router(g, r)
            for t in range(p):  # terminals
                e = (g * a + r) * p + t
                adj[e].append(sw), adj[sw].append(e)
            for r2 in range(r + 1, a):  # intra-group complete graph
                adj[sw].append(router(g, r2))
                adj[router(g, r2)].append(sw)
    for g in range(groups):  # global links, counted once per pair
        for g2 in range(g + 1, groups):
            for j in range(k):
                r1 = ((g2 - 1) * k + j) // h
                r2 = (g * k + j) // h
                adj[router(g, r1)].append(router(g2, r2))
                adj[router(g2, r2)].append(router(g, r1))
    return Network(
        n_endpoints=n, adj=dict(adj),
        meta={"kind": "dragonfly", "a": a, "p": p, "h": h, "groups": groups,
              "links_per_endpoint": 1},
    )


# ---------------------------------------------------------------------------
# Failure specs: the `fail=` leg of the scenario grammar
# ---------------------------------------------------------------------------

FAILURE_GRAMMAR = (
    "fail=<clause>[+<clause>...] with clause one of "
    "boards:<k|p%>[:seed<n>] | links:<k|p%>[:seed<n>] | "
    "nodes:<k|p%>[:seed<n>] | board:<bx>,<by> | node:<id> | link:<u>,<v>; "
    "legacy descriptors: int node id, ('node', id), ('board', bx, by), "
    "('link', u, v)"
)


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Parsed failure leg of a scenario string (``fail=boards:1%:seed7``).

    ``clauses`` holds normalized tuples::

        ("boards"|"links"|"nodes", ("count", k) | ("pct", p), seed)
        ("board", bx, by) | ("node", id) | ("link", u, v)

    Random clauses (plural kinds) are seeded samples resolved against a
    concrete network by ``realize``; explicit clauses pass through as legacy
    descriptors.  ``str()`` is canonical (``seed0`` omitted), so
    ``parse_failures(str(f)) == f``.
    """

    clauses: tuple[tuple, ...] = ()

    def __bool__(self) -> bool:
        return bool(self.clauses)

    def __str__(self) -> str:
        if not self.clauses:
            return ""
        return "fail=" + "+".join(_clause_str(c) for c in self.clauses)

    def realize(self, net: Network) -> list:
        """Resolve the clauses against a network into legacy descriptors."""
        out: list = []
        for c in self.clauses:
            kind = c[0]
            if kind == "board":
                out.append(("board", c[1], c[2]))
            elif kind == "node":
                out.append(int(c[1]))
            elif kind == "link":
                out.append(("link", c[1], c[2]))
            elif kind in ("boards", "links", "nodes"):
                out.extend(_sample_failures(net, kind, c[1], c[2]))
            else:  # pragma: no cover - parse_failures never emits others
                raise ValueError(f"unknown failure clause {c!r}; grammar: {FAILURE_GRAMMAR}")
        return out


def _clause_str(c: tuple) -> str:
    kind = c[0]
    if kind in ("boards", "links", "nodes"):
        how, amount = c[1]
        amt = f"{format(amount, 'g')}%" if how == "pct" else str(amount)
        seed = f":seed{c[2]}" if c[2] else ""
        return f"{kind}:{amt}{seed}"
    if kind == "node":
        return f"node:{c[1]}"
    return f"{kind}:{c[1]},{c[2]}"


def _board_grid(net: Network) -> tuple[int, int]:
    """Board grid (bx, by) dimensions; gridless fabrics (fat tree, dragonfly)
    present as a 1-row pool of ``board_size``-endpoint slots (as
    ``board_nodes``)."""
    meta = net.meta
    if meta.get("kind") == "hxmesh":
        return meta["x"], meta["y"]
    if meta.get("kind") == "torus":
        bd = meta.get("board", 2)
        return meta["side_x"] // bd, meta["side_y"] // bd
    bs = meta.get("board_size", 4)
    return net.n_endpoints // bs, 1


def _sample_failures(net: Network, kind: str, amount: tuple, seed: int):
    """Seeded sample of boards / links / endpoints for a random clause."""
    rng = np.random.default_rng(seed)
    if kind == "boards":
        x, y = _board_grid(net)
        pool: list = [("board", bx, by) for by in range(y) for bx in range(x)]
    elif kind == "nodes":
        pool = [int(e) for e in range(net.n_endpoints)]
    else:  # links: unique undirected bundles (one parallel link removed)
        U, V, _ = net.directed_edges()
        keep = U < V
        pool = [("link", int(u), int(v)) for u, v in zip(U[keep], V[keep])]
    how, value = amount
    count = value if how == "count" else int(round(value / 100.0 * len(pool)))
    count = max(0, min(int(count), len(pool)))
    if count == 0:
        return []
    idx = rng.choice(len(pool), size=count, replace=False)
    return [pool[i] for i in sorted(int(i) for i in idx)]


_RANDOM_CLAUSE_RE = re.compile(
    r"(boards|links|nodes):(\d+(?:\.\d+)?(?:e-?\d+)?)(%?)(?::seed(\d+))?")
_EXPLICIT_2_RE = re.compile(r"(board|link):(\d+),(\d+)")
_NODE_RE = re.compile(r"node:(\d+)")


def parse_failures(token) -> FailureSpec:
    """Parse a failure leg (with or without the ``fail=`` prefix) into a
    canonical ``FailureSpec``; '' parses to the empty spec.  Raises
    ``ValueError`` naming ``FAILURE_GRAMMAR`` on malformed input."""
    if isinstance(token, FailureSpec):
        return token
    if not isinstance(token, str):
        raise ValueError(f"failure spec must be a string, got {type(token)}; "
                         f"grammar: {FAILURE_GRAMMAR}")
    body = token.strip()
    if body.startswith("fail="):
        body = body[len("fail="):]
    if not body:
        return FailureSpec()
    clauses: list[tuple] = []
    for part in body.split("+"):
        m = _RANDOM_CLAUSE_RE.fullmatch(part)
        if m:
            how = "pct" if m[3] else "count"
            if how == "count" and not m[2].isdigit():
                raise ValueError(f"failure count must be an integer: {part!r}")
            value = float(m[2]) if m[3] else int(m[2])
            clauses.append((m[1], (how, value), int(m[4] or 0)))
            continue
        m = _EXPLICIT_2_RE.fullmatch(part)
        if m:
            clauses.append((m[1], int(m[2]), int(m[3])))
            continue
        m = _NODE_RE.fullmatch(part)
        if m:
            clauses.append(("node", int(m[1])))
            continue
        raise ValueError(f"unknown failure clause {part!r}; grammar: {FAILURE_GRAMMAR}")
    return FailureSpec(clauses=tuple(clauses))


# ---------------------------------------------------------------------------
# Uniform entry point: topology spec + failures -> Network
# ---------------------------------------------------------------------------


def build_network(topo, failures=()) -> Network:
    """Build the one-plane link graph for a topology spec and apply failures.

    ``topo`` is a ``Network`` (used as-is) or a ``repro_torch.core.topology``
    spec: ``HxMesh``, ``FatTree``, ``Torus2D`` or ``Dragonfly``.  ``failures``
    is a failure-spec string (``fail=boards:1%:seed7``), a ``FailureSpec``, or
    an iterable of legacy descriptors:

    * ``int``: node id (endpoint or switch) whose links are all removed,
    * ``("node", id)``: the same, tagged,
    * ``("board", bx, by)``: every accelerator of that board (HxMesh / Torus2D
      geometry from ``net.meta``),
    * ``("link", u, v)``: one parallel link between ``u`` and ``v``.

    Anything else raises ``ValueError`` naming ``FAILURE_GRAMMAR``.  Failed
    endpoints stay in the id space but become isolated; traffic builders
    consult ``Network.active_endpoints``.  A network with failures applied is
    flagged (``meta["failures_applied"]``), so the symmetry fast path never
    fires on a degraded fabric.
    """
    from repro_torch.core import topology as T

    if isinstance(topo, Network):
        base = topo
    elif isinstance(topo, T.HxMesh):
        base = build_hxmesh(topo.a, topo.b, topo.x, topo.y)
    elif isinstance(topo, T.FatTree):
        base = build_fat_tree(topo.num_accelerators, topo.taper)
    elif isinstance(topo, T.Torus2D):
        base = build_torus(topo.boards_x * topo.board, topo.boards_y * topo.board)
        base.meta["board"] = topo.board
    elif isinstance(topo, T.Dragonfly):
        base = build_dragonfly(topo.a, topo.p, topo.h, topo.groups)
    else:
        raise TypeError(f"unsupported topology spec: {type(topo).__name__}")
    if isinstance(failures, (str, FailureSpec)):
        failures = parse_failures(failures).realize(base)
    if not failures:
        return base

    adj = {u: list(nbrs) for u, nbrs in base.adj.items()}
    dead: set[int] = set()
    for f in failures:
        if isinstance(f, (int, np.integer)):
            dead.add(int(f))
        elif _is_descriptor(f, "node", 2):
            dead.add(int(f[1]))
        elif _is_descriptor(f, "board", 3):
            dead.update(board_nodes(base, int(f[1]), int(f[2])))
        elif _is_descriptor(f, "link", 3):
            u, v = int(f[1]), int(f[2])
            if v in adj.get(u, ()):
                adj[u].remove(v)
                adj[v].remove(u)
        else:
            raise ValueError(f"unknown failure descriptor {f!r}; supported grammar: "
                             f"{FAILURE_GRAMMAR}")
    for u in sorted(dead):
        for v in adj.get(u, ()):
            adj[v] = [w for w in adj[v] if w != u]
        adj[u] = []
    meta = dict(base.meta)
    meta["failures_applied"] = True
    return Network(n_endpoints=base.n_endpoints, adj=adj, meta=meta)


def _is_descriptor(f, kind: str, arity: int) -> bool:
    """True for a well-formed legacy failure tuple of the given kind."""
    return (isinstance(f, (tuple, list)) and len(f) == arity and f[0] == kind
            and all(isinstance(v, (int, np.integer)) for v in f[1:]))


# ---------------------------------------------------------------------------
# Placements: a job's isolated sub-fabric
# ---------------------------------------------------------------------------


def subnetwork(net: Network, endpoints) -> Network:
    """Induced sub-fabric for a placement: keep the given endpoints and every
    switch; every *other* endpoint loses its links (it stays in the id space,
    isolated, as a failed endpoint does).

    This is the fabric a job sees under the paper's §III-E isolation argument:
    routes may only cross the kept boards and the shared row and column switch
    trees, so ``achievable_fraction(subnetwork(net, eps), ...)`` is the job's
    *allocated* (isolated sub-HxMesh) bandwidth.
    """
    keep = set(int(e) for e in np.asarray(endpoints).ravel())
    return build_network(net, failures=[e for e in range(net.n_endpoints) if e not in keep])


def placement_endpoints(net: Network, boards) -> np.ndarray:
    """Endpoint ids covered by an iterable of board coordinates.

    Boards are ``(row, col)`` pairs as ``core.allocation.Placement.boards``
    gives them, i.e. ``(by, bx)`` in the builder's geometry: the transpose of
    ``board_nodes``'s ``(bx, by)`` argument order.
    """
    eps: list[int] = []
    for r, c in boards:
        eps.extend(board_nodes(net, int(c), int(r)))
    return np.array(sorted(eps), dtype=np.int64)


def board_nodes(net: Network, bx: int, by: int) -> list[int]:
    """Accelerator node ids of board ``(bx, by)`` (HxMesh board-major ids; for a
    plain torus, the 2x2-board tiling of the paper's comparison).

    Shapeless fabrics (fat tree, dragonfly) have no board grid, but the
    scheduler's pool allocator still hands out *slots* of ``board_size``
    consecutive endpoints: board ``(bx, 0)`` is slot ``bx``."""
    meta = net.meta
    if meta.get("kind") == "hxmesh":
        a, b, x = meta["a"], meta["b"], meta["x"]
        base = (by * x + bx) * a * b
        return list(range(base, base + a * b))
    if meta.get("kind") == "torus":
        side_x = meta["side_x"]
        bd = meta.get("board", 2)
        return [(by * bd + i) * side_x + (bx * bd + j) for i in range(bd) for j in range(bd)]
    bs = meta.get("board_size", 4)
    n_slots = net.n_endpoints // bs
    slot = by * n_slots + bx
    if not 0 <= slot < n_slots:
        raise ValueError(f"slot ({bx}, {by}) out of range for a {n_slots}-slot pool")
    return list(range(slot * bs, (slot + 1) * bs))


# ---------------------------------------------------------------------------
# Dense shims over core.traffic, and the legacy triple-list generators
# ---------------------------------------------------------------------------


def traffic_matrix(net: Network, pattern, **kw) -> np.ndarray:
    """Dense ``(n_endpoints, n_endpoints)`` demand matrix of a traffic token or
    pattern name (legacy keywords such as ``hot=`` / ``volume=`` accepted): the
    sparse ``Demand`` of ``core.traffic``, materialized.  At scale pass the
    token straight to ``achievable_fraction``, where this matrix cannot fit."""
    from repro_torch.core import traffic as TR

    return TR.demand(net, pattern, **kw).dense_full()


def __getattr__(name: str):
    # TRAFFIC_PATTERNS (pattern name -> dense matrix function): a live view over
    # the traffic-family registry.
    if name == "TRAFFIC_PATTERNS":
        import functools

        from repro_torch.core import traffic as TR

        names = list(TR.TRAFFIC_FAMILIES) + list(TR._ALIASES)
        return {n: functools.partial(traffic_matrix, pattern=n) for n in sorted(names)}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def alltoall_traffic(n: int, sample: int | None = None, seed: int = 0):
    """Uniform alltoall triples; optionally a sampled subset of sources."""
    rng = np.random.default_rng(seed)
    srcs = range(n) if sample is None else rng.choice(n, size=sample, replace=False)
    return [(int(s), int(t), 1.0 / (n - 1)) for s in srcs for t in range(n) if t != int(s)]


def ring_traffic(order: list[int], volume: float = 1.0):
    """Bidirectional ring neighbor triples (the allreduce steady state)."""
    n = len(order)
    tr = []
    for k in range(n):
        u, v = order[k], order[(k + 1) % n]
        tr.append((u, v, volume))
        tr.append((v, u, volume))
    return tr
