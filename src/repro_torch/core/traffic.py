"""Traffic specs and sparse demands (NumPy copy of ``repro.core.traffic``).

The port imports nothing of ``repro``, so it keeps its own copy of the
traffic objects that ``core/flowsim.py``'s ``max_link_load`` takes beside a
dense matrix:

* :class:`TrafficSpec`: a registered family name plus typed, canonical
  parameters (``skewed-alltoall:h8:seed3``).  Specs round-trip
  (``parse_traffic(str(t)) == t``), normalize aliases (``uniform`` ->
  ``alltoall``) and drop default-valued parameters.
* :class:`Demand`: a spec bound to a network, in sparse form: explicit
  per-source destination lists in CSR form plus uniform "spread" groups for
  alltoall-like backgrounds.  ``flowsim.demand_edge_loads`` materializes its
  dense rows one source chunk at a time, so the full ``(n, n)`` matrix never
  exists (a 16,384-endpoint float64 matrix is 2 GiB).

The nine families of the original are registered here with the same
builders and grammar.  Demands flagged ``symmetric``, and bisection demands
with a ``half_cut``, take the flow engine's symmetry-class fast path on a
healthy HxMesh or torus (``flowsim.demand_max_link_load``): one BFS a class
of endpoints instead of one an endpoint.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import numpy as np

from repro_torch.core import flowsim as F
from repro_torch.core import hamiltonian as ham

# ---------------------------------------------------------------------------
# Demand: sparse per-source destination lists + uniform spread groups
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpreadGroup:
    """One uniform component of a demand: every member source sends
    ``vol`` to each id in ``dsts`` (minus itself when ``zero_self``)."""

    members: np.ndarray  # bool mask over the demand's sources, shape (S,)
    dsts: np.ndarray  # destination endpoint ids
    vol: float  # volume per destination
    zero_self: bool = True


@dataclasses.dataclass(frozen=True)
class Demand:
    """A traffic spec bound to a network: sparse rows, materialized in
    chunks.

    ``sources`` are the endpoints with nonzero demand (ascending).  Row
    ``k`` (for ``sources[k]``) is the sum of the spread groups whose mask
    includes ``k`` plus the explicit CSR entries ``dsts/vols[indptr[k]:
    indptr[k+1]]``.  ``symmetric`` marks demands invariant under *every*
    endpoint automorphism of the fabric (uniform alltoall) — the flow
    engine may then measure one representative per symmetry class.
    """

    net: F.Network
    sources: np.ndarray  # (S,) endpoint ids
    indptr: np.ndarray  # (S + 1,) CSR row pointers
    dsts: np.ndarray  # explicit destination ids
    vols: np.ndarray  # explicit volumes (aggregated: no duplicate (s, t))
    groups: tuple[SpreadGroup, ...] = ()
    symmetric: bool = False
    # grid-row index of a bisection cut the demand is invariant under: the
    # demand only commutes with *half-preserving* fabric automorphisms
    # (board-row permutations within each side of the cut).  Set by the
    # bisection builder on healthy hxmesh fabrics; the flow engine then takes
    # the half-symmetry fast path (one BFS per side x on-board position)
    # instead of one BFS per endpoint.  ``None`` everywhere else.
    half_cut: int | None = None

    @property
    def n_sources(self) -> int:
        return len(self.sources)

    def rows(self, lo: int, hi: int) -> np.ndarray:
        """Dense demand rows for ``sources[lo:hi]`` — the only dense object
        the sparse path ever materializes (chunk x n_endpoints)."""
        n = self.net.n_endpoints
        srcs = self.sources[lo:hi]
        out = np.zeros((len(srcs), n), dtype=np.float64)
        for g in self.groups:
            rows = np.nonzero(g.members[lo:hi])[0]
            if len(rows) and len(g.dsts):
                out[np.ix_(rows, g.dsts)] += g.vol
                if g.zero_self:
                    out[np.arange(len(srcs)), srcs] = 0.0
        a, b = self.indptr[lo], self.indptr[hi]
        if b > a:
            row_ids = np.repeat(
                np.arange(len(srcs)), np.diff(self.indptr[lo:hi + 1]))
            np.add.at(out, (row_ids, self.dsts[a:b]), self.vols[a:b])
        return out

    def rows_for(self, source_ids) -> np.ndarray:
        """Dense rows for specific source endpoint ids (symmetry-class
        representatives); ids must be members of ``sources``."""
        idx = np.searchsorted(self.sources, np.asarray(source_ids))
        if (idx >= len(self.sources)).any() or \
                (self.sources[idx] != source_ids).any():
            raise ValueError(f"{source_ids!r} not all demand sources")
        out = np.concatenate(
            [self.rows(int(i), int(i) + 1) for i in idx], axis=0)
        return out

    def dense_full(self) -> np.ndarray:
        """Full ``(n_endpoints, n_endpoints)`` matrix (small fabrics,
        oracle tests, and the legacy dense engine path)."""
        n = self.net.n_endpoints
        T = np.zeros((n, n), dtype=np.float64)
        chunk = 1024
        for lo in range(0, self.n_sources, chunk):
            hi = min(lo + chunk, self.n_sources)
            T[self.sources[lo:hi]] = self.rows(lo, hi)
        return T


def _csr(entries: dict[int, dict[int, float]], sources: np.ndarray):
    """Aggregated (src -> dst -> vol) dict into CSR arrays over sources."""
    indptr = [0]
    dsts: list[int] = []
    vols: list[float] = []
    for s in sources:
        row = entries.get(int(s), {})
        for t in sorted(row):
            dsts.append(t)
            vols.append(row[t])
        indptr.append(len(dsts))
    return (np.asarray(indptr, dtype=np.int64),
            np.asarray(dsts, dtype=np.int64),
            np.asarray(vols, dtype=np.float64))


def _sparse_demand(net, entries: dict[int, dict[int, float]],
                   symmetric: bool = False) -> Demand:
    """Demand from an explicit (src -> dst -> vol) mapping (self-traffic
    and zero volumes dropped)."""
    clean: dict[int, dict[int, float]] = {}
    for s, row in entries.items():
        kept = {t: v for t, v in row.items() if t != s and v != 0.0}
        if kept:
            clean[s] = kept
    sources = np.asarray(sorted(clean), dtype=np.int64)
    indptr, dsts, vols = _csr(clean, sources)
    return Demand(net=net, sources=sources, indptr=indptr, dsts=dsts,
                  vols=vols, symmetric=symmetric)


def _empty_demand(net) -> Demand:
    z = np.zeros(0, dtype=np.int64)
    return Demand(net=net, sources=z, indptr=np.zeros(1, dtype=np.int64),
                  dsts=z, vols=np.zeros(0))


# ---------------------------------------------------------------------------
# Demand builders (one per registered family)
# ---------------------------------------------------------------------------


def _uniform_demand(net: F.Network) -> Demand:
    """Uniform alltoall: every active endpoint spreads unit volume over its
    peers.  Invariant under every endpoint automorphism -> ``symmetric``."""
    act = net.active_endpoints()
    if len(act) < 2:
        return _empty_demand(net)
    group = SpreadGroup(
        members=np.ones(len(act), dtype=bool), dsts=act,
        vol=1.0 / (len(act) - 1), zero_self=True)
    return Demand(
        net=net, sources=act,
        indptr=np.zeros(len(act) + 1, dtype=np.int64),
        dsts=np.zeros(0, dtype=np.int64), vols=np.zeros(0),
        groups=(group,), symmetric=True)


def _bit_complement_demand(net: F.Network, vol: float = 1.0) -> Demand:
    """Endpoint ``s`` sends to its reversal partner ``n - 1 - s`` (the
    classic bit-complement for power-of-two ``n``)."""
    n = net.n_endpoints
    act = set(net.active_endpoints().tolist())
    entries = {s: {n - 1 - s: vol} for s in sorted(act)
               if n - 1 - s != s and n - 1 - s in act}
    return _sparse_demand(net, entries)


def _ring_allreduce_demand(net: F.Network, vol: float | None = None) -> Demand:
    """Steady-state neighbor traffic of ring allreduce: the two
    edge-disjoint Hamiltonian cycles of the virtual torus when the
    geometry supports them (volume 0.25 per direction per ring), else a
    single bidirectional ring over the active endpoints at volume 0.5."""
    act = net.active_endpoints()
    rings: list[tuple[list[int], float]] = []
    geo = F._grid_geometry(net)
    if len(act) == net.n_endpoints and geo is not None:
        r, c, gid = geo
        try:
            red, green = ham.dual_cycles(r, c)
            v = 0.25 if vol is None else vol
            rings = [([gid(rr, cc) for rr, cc in red], v),
                     ([gid(rr, cc) for rr, cc in green], v)]
        except ValueError:
            pass
    if not rings:
        rings = [(act.tolist(), 0.5 if vol is None else vol)]
    entries: dict[int, dict[int, float]] = {}
    for order, v in rings:
        for k in range(len(order)):
            u, w = order[k], order[(k + 1) % len(order)]
            for s, t in ((u, w), (w, u)):
                entries.setdefault(s, {})
                entries[s][t] = entries[s].get(t, 0.0) + v
    return _sparse_demand(net, entries)


def _transpose_demand(net: F.Network, vol: float = 1.0) -> Demand:
    """Matrix transpose: grid position ``(i, j)`` sends to ``(j, i)``."""
    r, c, gid = F._grid_or_squarest(net, require_square=True)
    act = set(net.active_endpoints().tolist())
    entries: dict[int, dict[int, float]] = {}
    for i in range(r):
        for j in range(c):
            if i < c and j < r:
                s, t = gid(i, j), gid(j, i)
                if s != t and s in act and t in act:
                    entries[s] = {t: vol}
    return _sparse_demand(net, entries)


def _tornado_demand(net: F.Network, vol: float = 1.0) -> Demand:
    """Tornado: each endpoint sends ``(c-1)//2`` positions around its grid
    row — the worst case for minimal routing on rings/tori."""
    r, c, gid = F._grid_or_squarest(net)
    off = (c - 1) // 2
    act = set(net.active_endpoints().tolist())
    entries: dict[int, dict[int, float]] = {}
    if off:
        for i in range(r):
            for j in range(c):
                s, t = gid(i, j), gid(i, (j + off) % c)
                if s != t and s in act and t in act:
                    entries[s] = {t: vol}
    return _sparse_demand(net, entries)


def _permutation_demand(net: F.Network, seed: int = 0, samples: int = 1,
                        vol: float = 1.0) -> Demand:
    """Mean of ``samples`` seeded uniform permutations of the active
    endpoints (fixed points silent)."""
    act = net.active_endpoints()
    if len(act) < 2 or samples < 1:
        return _empty_demand(net)
    rng = np.random.default_rng(seed)
    entries: dict[int, dict[int, float]] = {}
    for _ in range(samples):
        perm = rng.permutation(act)
        for s, t in zip(act, perm):
            if s != t:
                entries.setdefault(int(s), {})
                entries[int(s)][int(t)] = (
                    entries[int(s)].get(int(t), 0.0) + vol / samples)
    return _sparse_demand(net, entries)


def _skewed_alltoall_demand(net: F.Network, skew: float = 0.75, h: int = 4,
                            seed: int = 0) -> Demand:
    """DLRM/MoE alltoall with per-source hot-expert skew: a ``skew`` share
    concentrated on ``h`` seeded hot destinations per source, the rest
    spread uniformly.  Sparse form: one background spread group + CSR hot
    entries (the hot sets are the only per-source state)."""
    if not 0.0 <= skew <= 1.0:
        raise ValueError(f"skew must be in [0, 1], got {skew}")
    act = net.active_endpoints()
    if len(act) < 2:
        return _empty_demand(net)
    groups = ()
    if skew < 1.0:
        groups = (SpreadGroup(
            members=np.ones(len(act), dtype=bool), dsts=act,
            vol=(1.0 - skew) / (len(act) - 1), zero_self=True),)
    rng = np.random.default_rng(seed)
    h = max(1, min(h, len(act) - 1))
    entries: dict[int, dict[int, float]] = {}
    for s in act:
        peers = act[act != s]
        hot_dsts = rng.choice(peers, size=h, replace=False)
        entries[int(s)] = {int(t): skew / h for t in hot_dsts}
    indptr, dsts, vols = _csr(entries, act)
    return Demand(net=net, sources=act, indptr=indptr, dsts=dsts, vols=vols,
                  groups=groups)


def _incast_demand(net: F.Network, k: int = 8, dst: int = 0,
                   vol: float = 1.0) -> Demand:
    """k-to-1 incast hotspot: ``k`` active endpoints all send to one
    destination — the classic congestion-tree microbenchmark.  The
    hotspot is the ``dst``-th active endpoint; senders are the next ``k``
    active endpoints cyclically after it."""
    if k < 1:
        raise ValueError(f"incast needs k >= 1 senders, got {k}")
    act = net.active_endpoints()
    if len(act) < 2:
        return _empty_demand(net)
    hot = int(act[dst % len(act)])
    senders = [int(s) for s in np.roll(act, -(dst % len(act)) - 1)
               if int(s) != hot][:k]
    entries = {s: {hot: vol} for s in senders}
    return _sparse_demand(net, entries)


def _bisection_demand(net: F.Network) -> Demand:
    """Cross-bisection uniform traffic: each active endpoint sends unit
    volume spread over the active endpoints of the opposite half, so the
    achievable fraction *is* the measured bisection fraction.  Halves
    follow the builder grid (HxMesh cuts align to a board boundary, per
    the §III-A inter-board cut), else the endpoint-id split; unequal
    halves rescale so each direction carries ``n/2`` total."""
    act = net.active_endpoints()
    if len(act) < 2:
        return _empty_demand(net)
    geo = F._grid_geometry(net)
    half_cut = None
    if geo is not None:
        r, c, gid = geo
        cut = r // 2
        if net.meta.get("kind") == "hxmesh":
            b = net.meta["b"]
            aligned = (cut // b) * b
            if 0 < aligned < r:
                cut = aligned
            if len(act) == net.n_endpoints and 0 < cut < r and cut % b == 0:
                half_cut = cut  # healthy fabric, board-aligned cut:
                # eligible for the half-symmetry fast path
        top = {gid(rr, cc) for rr in range(cut) for cc in range(c)}
        left = np.array([e for e in act if e in top], dtype=np.int64)
        right = np.array([e for e in act if e not in top], dtype=np.int64)
    else:
        half = len(act) // 2
        left, right = act[:half], act[half:]
    if not len(left) or not len(right):
        raise ValueError(
            "bisection pattern undefined: every active endpoint is on one "
            "side of the cut"
        )
    half = len(act) / 2.0
    sources = np.sort(np.concatenate([left, right]))
    in_left = np.isin(sources, left)
    groups = (
        SpreadGroup(members=in_left, dsts=right,
                    vol=half / len(left) / len(right), zero_self=False),
        SpreadGroup(members=~in_left, dsts=left,
                    vol=half / len(right) / len(left), zero_self=False),
    )
    return Demand(net=net, sources=sources,
                  indptr=np.zeros(len(sources) + 1, dtype=np.int64),
                  dsts=np.zeros(0, dtype=np.int64), vols=np.zeros(0),
                  groups=groups, half_cut=half_cut)


# ---------------------------------------------------------------------------
# TrafficSpec: the parsed, canonical traffic leg of a scenario string
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Param:
    """One typed parameter of a traffic family's grammar."""

    key: str  # spec-token key, e.g. "h" in "h8"
    type: type  # int | float
    default: object  # canonical forms omit default-valued params


@dataclasses.dataclass(frozen=True)
class TrafficFamily:
    """One traffic-spec family: a name, typed params, a demand builder."""

    name: str
    build: Callable[..., Demand]  # build(net, **{param.key: value})
    params: tuple[Param, ...] = ()
    aliases: tuple[str, ...] = ()
    doc: str = ""

    @property
    def grammar(self) -> str:
        """One-line grammar, e.g. ``skewed-alltoall[:h{int}][:seed{int}]``."""
        opts = "".join(
            f"[:{p.key}{{{p.type.__name__}}}]" for p in self.params)
        return self.name + opts


TRAFFIC_FAMILIES: dict[str, TrafficFamily] = {}
_ALIASES: dict[str, str] = {}


def register_traffic(family: TrafficFamily) -> None:
    """Register a traffic family (last registration wins on name clashes,
    like ``registry.register_family``)."""
    TRAFFIC_FAMILIES[family.name] = family
    for alias in family.aliases:
        _ALIASES[alias] = family.name


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """A parsed traffic spec: registered family + canonical typed params.

    The string form is the traffic leg of the scenario grammar:
    ``name[:key<value>...]`` with params sorted by key and defaults
    omitted, so ``parse_traffic(str(t)) == t``.
    """

    name: str
    params: tuple[tuple[str, object], ...] = ()  # sorted, non-default

    def __str__(self) -> str:
        return self.name + "".join(
            f":{k}{_fmt_value(v)}" for k, v in self.params)

    @property
    def opts(self) -> dict:
        return dict(self.params)

    @property
    def family(self) -> TrafficFamily:
        return TRAFFIC_FAMILIES[self.name]

    def demand(self, net: F.Network) -> Demand:
        """Bind the spec to a network: the sparse demand object the flow
        engine consumes."""
        fam = self.family
        kwargs = {p.key: p.default for p in fam.params}
        kwargs.update(self.opts)
        return fam.build(net, **kwargs)


def _fmt_value(v) -> str:
    return format(v, "g") if isinstance(v, float) else str(v)


_PARAM_RE = re.compile(r"([a-z]+)(-?[0-9.]+(?:e-?[0-9]+)?)")


def traffic_grammars() -> str:
    """One line per registered family (shared by parse error messages)."""
    return ", ".join(f.grammar for f in TRAFFIC_FAMILIES.values())


def parse_traffic(token) -> TrafficSpec:
    """Parse a traffic token (``skewed-alltoall:h8:seed3``) into its
    canonical :class:`TrafficSpec`.  Aliases normalize (``uniform`` ->
    ``alltoall``); default-valued params are dropped; raises ``ValueError``
    (listing the registered grammars) for malformed or unknown tokens."""
    if isinstance(token, TrafficSpec):
        return token
    if not isinstance(token, str):
        raise ValueError(f"traffic spec must be a string, got {type(token)}")
    parts = token.strip().split(":")
    name = _ALIASES.get(parts[0], parts[0])
    fam = TRAFFIC_FAMILIES.get(name)
    if fam is None:
        raise ValueError(
            f"unknown traffic pattern {parts[0]!r}; registered grammars: "
            + traffic_grammars()
        )
    by_key = {p.key: p for p in fam.params}
    seen: dict[str, object] = {}
    for tok in parts[1:]:
        m = _PARAM_RE.fullmatch(tok)
        p = by_key.get(m[1]) if m else None
        if p is None:
            raise ValueError(
                f"bad traffic param {tok!r} for {name!r}; grammar: "
                f"{fam.grammar}"
            )
        try:
            value = p.type(m[2])
        except ValueError:
            raise ValueError(
                f"param {tok!r}: {m[2]!r} is not a valid {p.type.__name__}"
            ) from None
        if m[1] in seen:
            raise ValueError(f"duplicate traffic param {m[1]!r} in {token!r}")
        seen[m[1]] = value
    params = tuple(sorted(
        (k, v) for k, v in seen.items() if v != by_key[k].default))
    return TrafficSpec(name=name, params=params)


def demand(net: F.Network, token, **kw) -> Demand:
    """One-shot: parse a traffic token (or legacy pattern-name + kwargs)
    and bind it to ``net``."""
    spec = parse_traffic(token)
    if kw:
        fam = spec.family
        by_key = {p.key: p for p in fam.params}
        legacy = {"hot": "h", "volume": "vol"}  # pre-grammar kwarg names
        merged = spec.opts
        for k, v in kw.items():
            k = legacy.get(k, k)
            if k not in by_key:
                continue  # legacy generators ignored foreign kwargs
            if v is None:  # legacy "auto" sentinel == the param default
                merged.pop(k, None)
                continue
            merged[k] = by_key[k].type(v)
        params = tuple(sorted(
            (k, v) for k, v in merged.items() if v != by_key[k].default))
        spec = TrafficSpec(name=spec.name, params=params)
    return spec.demand(net)


# ---------------------------------------------------------------------------
# The registered families (the original's nine)
# ---------------------------------------------------------------------------

register_traffic(TrafficFamily(
    name="alltoall", build=_uniform_demand, aliases=("uniform",),
    doc="uniform alltoall over active endpoints (unit volume per source)",
))
register_traffic(TrafficFamily(
    name="bit-complement", build=_bit_complement_demand,
    params=(Param("vol", float, 1.0),),
    doc="endpoint s -> n-1-s reversal partner",
))
register_traffic(TrafficFamily(
    name="ring-allreduce", build=_ring_allreduce_demand,
    params=(Param("vol", float, None),),
    doc="dual Hamiltonian ring neighbor traffic (allreduce steady state)",
))
register_traffic(TrafficFamily(
    name="transpose", build=_transpose_demand,
    params=(Param("vol", float, 1.0),),
    doc="grid (i,j) -> (j,i) permutation",
))
register_traffic(TrafficFamily(
    name="tornado", build=_tornado_demand,
    params=(Param("vol", float, 1.0),),
    doc="half-row offset permutation (worst case for minimal ring routing)",
))
register_traffic(TrafficFamily(
    name="permutation", build=_permutation_demand,
    params=(Param("seed", int, 0), Param("samples", int, 1),
            Param("vol", float, 1.0)),
    doc="mean of seeded uniform permutations",
))
register_traffic(TrafficFamily(
    name="skewed-alltoall", build=_skewed_alltoall_demand,
    params=(Param("h", int, 4), Param("skew", float, 0.75),
            Param("seed", int, 0)),
    doc="DLRM/MoE alltoall: `skew` share on `h` seeded hot experts/source",
))
register_traffic(TrafficFamily(
    name="bisection", build=_bisection_demand,
    doc="cross-cut uniform traffic; achievable fraction == bisection",
))
register_traffic(TrafficFamily(
    name="incast", build=_incast_demand,
    params=(Param("k", int, 8), Param("dst", int, 0),
            Param("vol", float, 1.0)),
    doc="k-to-1 hotspot: k senders converge on one destination endpoint",
))
