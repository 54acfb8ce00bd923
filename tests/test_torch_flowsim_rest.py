"""The rest of the port's flow simulator (``repro_torch.core.flowsim``) against
the JAX package's ``repro.core.flowsim``, on the CPU: failures, the dragonfly,
placements, the symmetry-class fast path, the bandwidth fractions, triple
lists and the dense traffic shims.

* Failures: ``parse_failures`` gives the original's clauses and canonical
  strings, which round-trip, and refuses what it refuses with its message;
  ``FailureSpec.realize`` draws the original's descriptors for the same seed;
  ``build_network`` gives the original's adjacency, dict for dict, from the
  port's own ``core.topology`` specs (``tests/test_flowsim_vec.py``'s failure,
  dragonfly, subnetwork and spec tests mirrored).
* The symmetry path: ``endpoint_classes`` and ``edge_orbit_ids`` equal the
  original's array for array, the half-cut subgroup included, and
  ``symmetric_max_link_load`` its value exactly (the same float64
  arithmetic), up to Table II's 16,384-accelerator HxMeshes
  (``tests/test_traffic.py``'s symmetry tests mirrored).
* Loads and fractions equal the original's exactly on the NumPy engine, and
  within rel 1e-5 (float32) on ``backend="torch", device="cpu"`` against both
  of its backends; a triple list gives the original's answer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import flowsim as F  # noqa: E402
from repro.core import flowsim_oracle as O  # noqa: E402
from repro.core import topology as OTOP  # noqa: E402
from repro.core import traffic as OT  # noqa: E402
from repro_torch.core import flowsim as G  # noqa: E402
from repro_torch.core import topology as TOP  # noqa: E402
from repro_torch.core import traffic as T  # noqa: E402

RTOL = 1e-5  # float32 on the torch backend: tests/test_flowsim_vec.py's JAX tolerance

FABRICS = {
    "hx2-4x4": lambda M: M.build_hxmesh(2, 2, 4, 4),
    "hx4x2-4x4": lambda M: M.build_hxmesh(4, 2, 4, 4),
    "hx2-8x8": lambda M: M.build_hxmesh(2, 2, 8, 8),
    "hx4-4x4": lambda M: M.build_hxmesh(4, 4, 4, 4),
    "hyperx-8x8": lambda M: M.build_hxmesh(1, 1, 8, 8),
    "torus-8x8": lambda M: M.build_torus(8, 8),
    "ft64-t50": lambda M: M.build_fat_tree(64, 0.5),
    "df-4x2x2x9": lambda M: M.build_dragonfly(4, 2, 2, 9),
}
SYMMETRIC_FABRICS = ["hx2-4x4", "hx4x2-4x4", "hyperx-8x8", "torus-8x8"]
HALF_SYMMETRIC_FABRICS = ["hx2-4x4", "hx2-8x8", "hx4x2-4x4", "hx4-4x4", "hyperx-8x8"]
# the same spec in each package's core.topology
SPECS = {
    "hxmesh": lambda M: M.HxMesh(2, 2, 4, 4),
    "fat_tree": lambda M: M.FatTree(64, 0.5),
    "torus": lambda M: M.Torus2D(4, 4),
    "dragonfly": lambda M: M.Dragonfly(a=4, p=2, h=2, groups=9),
}
FAILURE_TOKENS = ["", "fail=", "boards:1%:seed7", "fail=boards:2", "links:5%:seed3",
                  "nodes:3:seed1", "boards:12.5%", "nodes:1e-1%:seed4", "board:1,2",
                  "node:9", "link:0,1", "fail=boards:1:seed2+link:0,1+node:5",
                  "boards:0%:seed0"]
BAD_FAILURE_TOKENS = ["boards", "boards:x", "boards:1.5", "board:1", "node:-1", "link:0",
                      "fail=boards:1%+", "racks:1", "boards:1%:seedx", 7, ("board", 1, 2)]
_NETS: dict = {}


def _pair(name):
    """(the original's network, the port's) of a fabric, built once."""
    if name not in _NETS:
        _NETS[name] = FABRICS[name](F), FABRICS[name](G)
    return _NETS[name]


def _same_network(net, ref):
    assert net.n_endpoints == ref.n_endpoints and net.adj == ref.adj and net.meta == ref.meta
    for a, b in zip(net.directed_edges(), ref.directed_edges(), strict=True):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Failures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("token", FAILURE_TOKENS)
def test_parse_failures_round_trips_as_the_original(token):
    got, want = G.parse_failures(token), F.parse_failures(token)
    assert got.clauses == want.clauses
    assert (str(got), bool(got)) == (str(want), bool(want))
    assert G.parse_failures(str(got)) == got
    assert G.parse_failures(got) is got


@pytest.mark.parametrize("token", BAD_FAILURE_TOKENS)
def test_parse_failures_refuses_what_the_original_refuses(token):
    with pytest.raises(ValueError) as want:
        F.parse_failures(token)
    with pytest.raises(ValueError) as got:
        G.parse_failures(token)
    assert str(got.value) == str(want.value)
    assert G.FAILURE_GRAMMAR == F.FAILURE_GRAMMAR


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("token", ["boards:25%:seed3", "links:5:seed1", "nodes:2%:seed9",
                                   "boards:1+nodes:1:seed5", "board:1,0+node:3+link:0,1"])
def test_realize_draws_the_originals_descriptors(token, spec):
    ref, net = F.build_network(SPECS[spec](OTOP)), G.build_network(SPECS[spec](TOP))
    _same_network(net, ref)
    want = F.parse_failures(token).realize(ref)
    assert G.parse_failures(token).realize(net) == want
    _same_network(G.build_network(SPECS[spec](TOP), token),
                  F.build_network(SPECS[spec](OTOP), token))


def test_failure_injection_matches_oracle():
    """Board + node + link failures: the port's engine, the original's and its
    scalar oracle agree on the broken graph (a triple list), and the
    achievable fraction degrades (not improves)."""
    healthy = G.build_network(TOP.HxMesh(2, 2, 4, 4))
    failures = [("board", 1, 2), 5, ("link", 0, 1)]
    broken = G.build_network(TOP.HxMesh(2, 2, 4, 4), failures=failures)
    ref = F.build_network(OTOP.HxMesh(2, 2, 4, 4), failures=failures)
    _same_network(broken, ref)
    assert broken.meta["failures_applied"] is True
    act = broken.active_endpoints()
    assert len(act) < healthy.n_endpoints
    tr = [(int(s), int(t), 1.0 / (len(act) - 1)) for s in act for t in act if s != t]
    got = G.max_link_load(broken, tr)
    assert got == F.max_link_load(ref, tr)
    assert got == pytest.approx(O.max_link_load(ref, tr), abs=1e-9)
    frac_healthy = G.achievable_fraction(healthy, G.traffic_matrix(healthy, "alltoall"), 4)
    frac_broken = G.achievable_fraction(broken, G.traffic_matrix(broken, "alltoall"), 4)
    assert frac_broken <= frac_healthy + 1e-9
    assert frac_broken == F.achievable_fraction(ref, F.traffic_matrix(ref, "alltoall"), 4)


def test_failure_edge_cases():
    """Failing a board twice is idempotent; failing every endpoint of a board
    equals failing the board; malformed descriptors and specs are refused as
    the original refuses them."""
    spec = TOP.HxMesh(2, 2, 4, 4)
    once = G.build_network(spec, failures=[("board", 1, 2)])
    twice = G.build_network(spec, failures=[("board", 1, 2), ("board", 1, 2)])
    assert once.adj == twice.adj
    by_nodes = G.build_network(spec, failures=G.board_nodes(once, 1, 2))
    assert by_nodes.adj == once.adj
    gone = set(G.board_nodes(once, 1, 2))
    assert gone.isdisjoint(once.active_endpoints().tolist())
    assert len(once.active_endpoints()) == once.n_endpoints - len(gone)
    _same_network(once, F.build_network(OTOP.HxMesh(2, 2, 4, 4), failures=[("board", 1, 2)]))
    for bad in ([("board", 1)], [("link", 0, "1")], ["node:3"], [1.5]):
        with pytest.raises(ValueError) as want:
            F.build_network(OTOP.HxMesh(2, 2, 4, 4), failures=bad)
        with pytest.raises(ValueError) as got:
            G.build_network(spec, failures=bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="unsupported topology spec"):
        G.build_network(OTOP.HxMesh(2, 2, 4, 4))  # the original's spec is not the port's
    with pytest.raises(ValueError, match="out of range"):
        G.board_nodes(G.build_fat_tree(64), 16, 0)


# ---------------------------------------------------------------------------
# The dragonfly, specs and placements
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,p,h,groups", [(4, 2, 2, 9), (16, 8, 8, 9), (2, 1, 1, 3)])
def test_dragonfly_structure(a, p, h, groups):
    """Canonical Dragonfly invariants: router degree p + (a-1) + h, exactly h
    global links per router, a balanced group-pair all-to-all; the original's
    node ids and wiring."""
    net = G.build_dragonfly(a, p, h, groups)
    _same_network(net, F.build_dragonfly(a, p, h, groups))
    n = net.n_endpoints
    assert n == a * p * groups

    def group_of(router: int) -> int:
        return (router - n) // a

    k = (a * h) // (groups - 1)  # global links per group pair
    pair_links: dict[tuple[int, int], int] = {}
    for r in range(n, n + a * groups):
        nbrs = net.adj[r]
        terminals = [v for v in nbrs if v < n]
        local = [v for v in nbrs if v >= n and group_of(v) == group_of(r)]
        global_links = [v for v in nbrs if v >= n and group_of(v) != group_of(r)]
        assert len(terminals) == p
        assert sorted(set(local)) == sorted(local)  # no parallel local links
        assert len(local) == a - 1  # complete intra-group graph
        assert len(global_links) == h  # global degree exactly h
        for v in global_links:
            g1, g2 = sorted((group_of(r), group_of(v)))
            pair_links[(g1, g2)] = pair_links.get((g1, g2), 0) + 1
    assert len(pair_links) == groups * (groups - 1) // 2
    assert set(pair_links.values()) == {2 * k}
    for e in range(n):
        assert len(net.adj[e]) == 1 and net.adj[e][0] >= n


@pytest.mark.parametrize("a,p,h,groups", [(16, 8, 8, 8), (32, 17, 16, 30)])
def test_table_ii_dragonflies_fail_the_builders_assertion_in_both(a, p, h, groups):
    """Table II's own dragonflies do not divide a*h into group pairs."""
    for M in (F, G):
        with pytest.raises(AssertionError, match="group pairs"):
            M.build_dragonfly(a, p, h, groups)


@pytest.mark.parametrize("spec", list(SPECS))
def test_build_network_specs_and_patterns(spec):
    """The uniform entry point covers every topology spec, and every traffic
    pattern gives the original's dense demand matrix."""
    net, ref = G.build_network(SPECS[spec](TOP)), F.build_network(SPECS[spec](OTOP))
    _same_network(net, ref)
    assert net.n_endpoints > 0 and net.n_nodes >= net.n_endpoints
    pats = G.TRAFFIC_PATTERNS
    assert list(pats) == list(F.TRAFFIC_PATTERNS)
    for pattern in pats:
        Tm = pats[pattern](net)
        assert Tm.shape == (net.n_endpoints, net.n_endpoints)
        assert (Tm >= 0).all() and np.diagonal(Tm).max() == 0.0
        np.testing.assert_array_equal(Tm, F.traffic_matrix(ref, pattern))
    np.testing.assert_array_equal(G.traffic_matrix(net, "skewed-alltoall", hot=8),
                                  F.traffic_matrix(ref, "skewed-alltoall", hot=8))
    with pytest.raises(ValueError):
        G.traffic_matrix(net, "no-such-pattern")
    with pytest.raises(AttributeError, match="NO_SUCH"):
        G.NO_SUCH  # noqa: B018


@pytest.mark.parametrize("name", ["hx2-4x4", "torus-8x8", "ft64-t50", "df-4x2x2x9"])
def test_subnetwork_extraction(name):
    """Placement sub-network: kept endpoints keep their fabric, foreign
    endpoints are isolated, keeping everything is the identity; the
    original's endpoints and adjacency (the slot pool of a shapeless fabric)."""
    ref, net = _pair(name)
    if net.meta["kind"] in ("fat_tree", "dragonfly"):
        boards = [(0, 0), (0, 3), (0, 5)]  # slots of the pool's one row
    elif net.meta["kind"] == "torus":
        boards = [(0, 0), (0, 1), (1, 0), (1, 1)]  # a torus has no switches: adjacent boards
    else:
        boards = [(0, 0), (0, 2), (1, 0), (1, 2)]  # a 2x2 virtual sub-HxMesh
    eps = G.placement_endpoints(net, boards)
    np.testing.assert_array_equal(eps, F.placement_endpoints(ref, boards))
    assert sorted(eps) == sorted(e for (r, c) in boards for e in G.board_nodes(net, c, r))
    sub = G.subnetwork(net, eps)
    _same_network(sub, F.subnetwork(ref, eps))
    assert sorted(sub.active_endpoints().tolist()) == sorted(eps.tolist())
    D, _ = G.shortest_paths(sub, sources=eps)
    assert (D[:, eps] >= 0).all()
    assert G.subnetwork(net, np.arange(net.n_endpoints)).adj == net.adj


# ---------------------------------------------------------------------------
# The symmetry-class fast path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fabric", SYMMETRIC_FABRICS)
def test_symmetry_path_matches_dense(fabric):
    """One representative BFS a class equals the full dense engine, and the
    original's symmetry path exactly."""
    ref, net = _pair(fabric)
    dem = T.parse_traffic("alltoall").demand(net)
    sym = G.symmetric_max_link_load(net, dem)
    assert sym is not None, f"{fabric} should declare symmetry classes"
    assert sym == F.symmetric_max_link_load(ref, OT.parse_traffic("alltoall").demand(ref))
    assert sym == pytest.approx(G.max_link_load(net, dem.dense_full()), rel=1e-6)


def test_symmetry_class_counts():
    """hxmesh: one class per on-board position; torus and hyperx: one class;
    the original's class ids."""
    for a, b, x, y, want in ((2, 2, 4, 4, 4), (1, 1, 8, 8, 1), (4, 2, 4, 4, 8)):
        cls = G.endpoint_classes(G.build_hxmesh(a, b, x, y))
        assert len(np.unique(cls)) == want
        np.testing.assert_array_equal(cls, F.endpoint_classes(F.build_hxmesh(a, b, x, y)))
    assert len(np.unique(G.endpoint_classes(G.build_torus(8, 8)))) == 1
    assert G.endpoint_classes(G.build_fat_tree(64, 0.0)) is None
    assert G.edge_orbit_ids(G.build_dragonfly(4, 2, 2, 9)) is None


@pytest.mark.parametrize("fabric", ["hx2-4x4", "hx4x2-4x4", "torus-8x8"])
def test_edge_orbits_are_load_invariant(fabric):
    """The declared orbits are the original's, and symmetry orbits: under
    uniform alltoall the per-edge loads are constant within each orbit."""
    ref, net = _pair(fabric)
    orbits = G.edge_orbit_ids(net)
    np.testing.assert_array_equal(orbits, F.edge_orbit_ids(ref))
    loads = G.edge_loads(net, T.parse_traffic("alltoall").demand(net).dense_full())
    for o in np.unique(orbits):
        grp = loads[orbits == o]
        assert grp.max() - grp.min() < 1e-9, (fabric, int(o))


@pytest.mark.parametrize("fabric", HALF_SYMMETRIC_FABRICS)
def test_half_symmetry_path_matches_chunked_bisection(fabric):
    """Bisection takes the half-preserving symmetry path on healthy hxmesh
    fabrics: one BFS per (side x on-board position) class equals the full
    chunked pass, and the original's value exactly."""
    ref, net = _pair(fabric)
    dem = T.parse_traffic("bisection").demand(net)
    assert dem.half_cut is not None, f"{fabric} should set half_cut"
    sym = G.symmetric_max_link_load(net, dem)
    assert sym is not None, f"{fabric} should take the half-symmetry path"
    assert sym == pytest.approx(float(G.demand_edge_loads(net, dem).max()), rel=1e-9)
    assert sym == F.symmetric_max_link_load(ref, OT.parse_traffic("bisection").demand(ref))
    for half_cut in {dem.half_cut, 3}:
        np.testing.assert_array_equal(G.edge_orbit_ids(net, half_cut=half_cut),
                                      F.edge_orbit_ids(ref, half_cut=half_cut))


def test_half_symmetry_class_counts():
    """Half-preserving classes double the full count (side x position); a cut
    off the board boundary, and the torus's, are refused, as the original."""
    net, ref = G.build_hxmesh(2, 2, 4, 4), F.build_hxmesh(2, 2, 4, 4)
    full = G.endpoint_classes(net)
    half = G.endpoint_classes(net, half_cut=4)
    assert len(np.unique(half)) == 2 * len(np.unique(full))
    np.testing.assert_array_equal(half, F.endpoint_classes(ref, half_cut=4))
    for cut in (3, 0, 8):  # b = 2, y = 4: 3 straddles a board, 0 and 8 are edges
        assert G.endpoint_classes(net, half_cut=cut) is None
        assert G.edge_orbit_ids(net, half_cut=cut) is None
        assert F.endpoint_classes(ref, half_cut=cut) is None
    assert G.endpoint_classes(G.build_torus(8, 8), half_cut=4) is None
    assert G.edge_orbit_ids(G.build_torus(8, 8), half_cut=4) is None


def test_half_edge_orbits_are_load_invariant():
    """Under the bisection demand, per-edge loads are constant within each
    half-preserving orbit."""
    net = G.build_hxmesh(2, 2, 4, 4)
    dem = T.parse_traffic("bisection").demand(net)
    orbits = G.edge_orbit_ids(net, half_cut=dem.half_cut)
    loads = G.edge_loads(net, dem.dense_full())
    for o in np.unique(orbits):
        grp = loads[orbits == o]
        assert grp.max() - grp.min() < 1e-9, int(o)


def test_bisection_no_half_cut_off_grid():
    """Fabrics without an aligned cut, and degraded ones, keep half_cut None
    and take the chunked pass."""
    assert T.parse_traffic("bisection").demand(G.build_torus(8, 8)).half_cut is None
    degraded = G.build_network(TOP.HxMesh(2, 2, 4, 4), failures="fail=boards:1:seed2")
    dem = T.parse_traffic("bisection").demand(degraded)
    assert dem.half_cut is None
    assert G.symmetric_max_link_load(degraded, dem) is None


def test_symmetry_disabled_under_failures():
    """A degraded fabric never takes the symmetry shortcut; its sparse chunked
    pass equals the dense engine and the original's."""
    net = G.build_network(TOP.HxMesh(2, 2, 4, 4), failures=[("board", 0, 0)])
    ref = F.build_network(OTOP.HxMesh(2, 2, 4, 4), failures=[("board", 0, 0)])
    assert net.meta.get("failures_applied")
    assert G.endpoint_classes(net) is None and G.edge_orbit_ids(net) is None
    dem = T.parse_traffic("alltoall").demand(net)
    assert G.symmetric_max_link_load(net, dem) is None
    got = G.demand_max_link_load(net, dem)
    assert got == pytest.approx(G.max_link_load(net, dem.dense_full()), abs=1e-9)
    assert got == F.demand_max_link_load(ref, OT.parse_traffic("alltoall").demand(ref))


@pytest.mark.parametrize("shape,want_load,want_frac", [
    ((2, 2, 64, 64), 0.984435085149, 0.253952753),
    ((4, 4, 32, 32), 2.764483509329, 0.090432806)])
def test_profile_at_16k_endpoints_via_symmetry(shape, want_load, want_frac):
    """Table II's large Hx2Mesh and Hx4Mesh (16,384 accelerators each):
    uniform alltoall through the symmetry path, 4 and 16 representatives
    where the chunked pass runs 16,384 sources; the original's classes,
    orbits and value exactly."""
    net, ref = G.build_hxmesh(*shape), F.build_hxmesh(*shape)
    assert net.n_endpoints == 16384
    np.testing.assert_array_equal(G.endpoint_classes(net), F.endpoint_classes(ref))
    np.testing.assert_array_equal(G.edge_orbit_ids(net), F.edge_orbit_ids(ref))
    dem = T.parse_traffic("alltoall").demand(net)
    mx = G.symmetric_max_link_load(net, dem)
    assert mx == F.symmetric_max_link_load(ref, OT.parse_traffic("alltoall").demand(ref))
    assert mx == pytest.approx(want_load, rel=1e-11)
    frac = G.alltoall_fraction(net, 4)
    assert frac == pytest.approx(want_frac, rel=1e-8)
    if shape[0] == 2:  # the paper's large-cluster Hx2Mesh alltoall is 0.254
        assert frac == pytest.approx(0.254, rel=0.05)


# ---------------------------------------------------------------------------
# Fractions, backends and triple lists
# ---------------------------------------------------------------------------


def _failed_pair():
    token = "fail=boards:1%:seed7"
    return (F.build_network(OTOP.HxMesh(2, 2, 8, 8), token),
            G.build_network(TOP.HxMesh(2, 2, 8, 8), token))


@pytest.mark.parametrize("name", ["hx2-4x4", "torus-8x8", "ft64-t50", "df-4x2x2x9", "failed",
                                  "subnetwork"])
def test_fractions_match_the_original_on_both_backends(name):
    """``alltoall_fraction`` and ``achievable_fraction`` exactly on the NumPy
    engine, and within rel 1e-5 on the torch backend against the original's
    ``backend="numpy"`` and ``backend="jax"``."""
    if name == "failed":
        ref, net = _failed_pair()
    elif name == "subnetwork":
        ref, net = _failed_pair()
        boards = [(r, c) for r in range(4) for c in range(4)]
        ref = F.subnetwork(ref, F.placement_endpoints(ref, boards))
        net = G.subnetwork(net, G.placement_endpoints(net, boards))
    else:
        ref, net = _pair(name)
    _same_network(net, ref)
    links = net.meta["links_per_endpoint"]
    want = F.alltoall_fraction(ref, links)
    assert G.alltoall_fraction(net, links) == want
    for token in ("alltoall", "ring-allreduce"):
        assert G.achievable_fraction(net, token, links) == F.achievable_fraction(ref, token,
                                                                                links)
    got = G.alltoall_fraction(net, links, source_chunk=40, backend="torch", device="cpu")
    for backend in ("numpy", "jax"):
        assert got == pytest.approx(F.alltoall_fraction(ref, links, backend=backend), rel=RTOL)
    dense = G.traffic_matrix(net, "alltoall")
    assert G.achievable_fraction(net, dense, links, backend="torch",
                                 device="cpu") == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", ["hx2-4x4", "torus-8x8", "df-4x2x2x9", "failed"])
def test_triple_lists_give_the_originals_answer(name):
    """The legacy ``(s, t, vol)`` list: sampled alltoall, a ring, and a list
    with self-traffic and repeats, on both engines."""
    ref, net = _failed_pair() if name == "failed" else _pair(name)
    n = net.n_endpoints
    act = [int(e) for e in net.active_endpoints()]
    lists = [G.alltoall_traffic(n, sample=5, seed=3), G.ring_traffic(act[::3], volume=0.5),
             [(act[0], act[0], 1.0), (act[0], act[-1], 0.25), (act[0], act[-1], 0.25),
              (act[1], act[2], 1.0)]]
    assert lists[0] == F.alltoall_traffic(n, sample=5, seed=3)
    assert lists[1] == F.ring_traffic(act[::3], volume=0.5)
    for tr in lists:
        want = F.max_link_load(ref, tr)
        assert G.max_link_load(net, tr) == want
        assert G.max_link_load(net, tr, backend="torch", device="cpu") == pytest.approx(
            want, rel=RTOL)
        assert G.achievable_fraction(net, tr, 4) == F.achievable_fraction(ref, tr, 4)
    assert G.max_link_load(net, []) == F.max_link_load(ref, []) == 0.0


def test_symmetric_demands_take_the_numpy_fast_path_whatever_the_backend():
    """As the original: on a healthy HxMesh, ``max_link_load`` of a symmetric
    token runs its representatives on the NumPy engine (no device chunk), and
    ``demand_edge_loads`` on the torch backend is the device pass over every
    source; an unknown backend is refused first, and without a GPU the torch
    backend raises whichever path would run."""
    net = G.build_hxmesh(2, 2, 4, 4)
    G.device_chunks = 0
    for token in ("alltoall", "bisection"):
        assert G.max_link_load(net, token, backend="torch", device="cpu") == \
            G.max_link_load(net, token)
    assert G.device_chunks == 0
    dem = T.demand(net, "alltoall")
    loads = G.demand_edge_loads(net, dem, source_chunk=16, backend="torch", device="cpu")
    assert G.device_chunks == 4  # 64 sources in chunks of 16
    assert loads.max() == pytest.approx(G.max_link_load(net, dem), rel=RTOL)
    with pytest.raises(ValueError, match="backend"):
        G.demand_max_link_load(net, dem, backend="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            G.alltoall_fraction(net, 4, backend="torch")
