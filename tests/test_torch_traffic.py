"""The port's traffic specs and sparse demands (``repro_torch.core.traffic``) and
the flow simulator's demand path (``repro_torch.core.flowsim``:
``demand_edge_loads``, ``demand_max_link_load`` and ``max_link_load`` of a
``Demand``, a ``TrafficSpec`` or a token) against the JAX package's
``repro.core.traffic`` and ``repro.core.flowsim``, on the CPU.

* Every registered family's ``Demand`` on the fabrics of
  ``tests/test_torch_flowsim.py`` and on an HxMesh with failed nodes (each
  package's own ``build_network``): its sources, CSR rows, spread groups,
  flags and dense rows equal the original's.
* ``parse_traffic`` gives the original's canonical specs and strings, which
  round-trip; aliases, defaults, legacy keyword arguments and malformed tokens
  as in the original.
* The port's NumPy engine gives the original's chunked loads exactly (the
  same float64 arithmetic).
* ``max_link_load`` / ``demand_max_link_load`` with ``backend="torch",
  device="cpu"`` agree with the original's ``backend="numpy"`` and
  ``backend="jax"`` within rel 1e-5 (float32, ``test_torch_flowsim.py``'s
  tolerance).  For the symmetric tokens (alltoall, bisection) on a healthy
  HxMesh or torus both packages take the symmetry-class fast path on the
  NumPy engine, so ``demand_edge_loads`` on the torch backend (the device
  pass, its chunks counted) is held to the same values.
* Without ``device="cpu"`` the torch backend wants a GPU and raises here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import flowsim as F  # noqa: E402
from repro.core import traffic as OT  # noqa: E402
from repro_torch.core import flowsim as G  # noqa: E402
from repro_torch.core import traffic as T  # noqa: E402

NETS = {
    "torus8x8": lambda M: M.build_torus(8, 8),
    "hxmesh2x2-4x4": lambda M: M.build_hxmesh(2, 2, 4, 4),
    "fat_tree64": lambda M: M.build_fat_tree(64, 0.5),
    "hxmesh2x2-16x16": lambda M: M.build_hxmesh(2, 2, 16, 16),
}
FAILED = [5, 17, ("board", 1, 2)]  # two accelerators and a board of the 4x4 HxMesh
FABRICS = [*NETS, "failed"]
# one token a family, with parameters where it takes them
TOKENS = ["alltoall", "bit-complement", "ring-allreduce", "transpose", "tornado",
          "permutation:seed1", "skewed-alltoall:h8:seed3", "bisection", "incast:k4:dst3"]
RTOL = 1e-5
_NETS: dict = {}


def _pair(name):
    """(the original's network, the port's) of a fabric, built once."""
    if name not in _NETS:
        if name == "failed":
            ref = F.build_network(F.build_hxmesh(2, 2, 4, 4), failures=FAILED)
            net = G.build_network(G.build_hxmesh(2, 2, 4, 4), failures=FAILED)
            assert net.adj == ref.adj and net.meta == ref.meta
        else:
            ref, net = NETS[name](F), NETS[name](G)
        _NETS[name] = ref, net
    return _NETS[name]


def test_the_registry_is_the_originals():
    assert list(T.TRAFFIC_FAMILIES) == list(OT.TRAFFIC_FAMILIES)
    assert [t.split(":")[0] for t in TOKENS] == list(T.TRAFFIC_FAMILIES)
    for name, fam in T.TRAFFIC_FAMILIES.items():
        ref = OT.TRAFFIC_FAMILIES[name]
        assert fam.grammar == ref.grammar and fam.aliases == ref.aliases
        assert [(p.key, p.type, p.default) for p in fam.params] == [
            (p.key, p.type, p.default) for p in ref.params]
    assert T.traffic_grammars() == OT.traffic_grammars()


@pytest.mark.parametrize("name", FABRICS)
@pytest.mark.parametrize("token", TOKENS)
def test_demand_rows_match_the_original(token, name):
    ref_net, net = _pair(name)
    want, got = OT.demand(ref_net, token), T.demand(net, token)
    for field in ("sources", "indptr", "dsts", "vols"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert (got.symmetric, got.half_cut, got.n_sources) == (
        want.symmetric, want.half_cut, want.n_sources)
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        np.testing.assert_array_equal(g.members, w.members)
        np.testing.assert_array_equal(g.dsts, w.dsts)
        assert (g.vol, g.zero_self) == (w.vol, w.zero_self)
    np.testing.assert_array_equal(got.dense_full(), want.dense_full())
    k = got.n_sources
    np.testing.assert_array_equal(got.rows(k // 3, k), want.rows(k // 3, k))
    if k:
        ids = got.sources[[0, k - 1]]
        np.testing.assert_array_equal(got.rows_for(ids), want.rows_for(ids))


@pytest.mark.parametrize("token", [*TOKENS, "uniform", "skewed-alltoall:skew0.5:h4",
                                   "skewed-alltoall:seed2:h6", "permutation:samples3:vol2",
                                   "ring-allreduce:vol0.5", "incast:dst0:k8"])
def test_parse_traffic_round_trips_as_the_original(token):
    got, want = T.parse_traffic(token), OT.parse_traffic(token)
    assert (got.name, got.params, str(got)) == (want.name, want.params, str(want))
    assert T.parse_traffic(str(got)) == got
    assert T.parse_traffic(got) is got


@pytest.mark.parametrize("token", ["nope", "alltoall:h3", "skewed-alltoall:hx",
                                   "skewed-alltoall:h2:h3", "permutation:seed1.5", 7])
def test_parse_traffic_refuses_what_the_original_refuses(token):
    with pytest.raises(ValueError) as want:
        OT.parse_traffic(token)
    with pytest.raises(ValueError) as got:
        T.parse_traffic(token)
    assert str(got.value) == str(want.value)


def test_legacy_keywords_bind_as_the_original():
    ref_net, net = _pair("hxmesh2x2-4x4")
    for token, kw in (("skewed-alltoall", {"hot": 8}), ("bit-complement", {"volume": 2.0}),
                      ("ring-allreduce", {"vol": None}), ("tornado", {"foreign": 1})):
        np.testing.assert_array_equal(T.demand(net, token, **kw).dense_full(),
                                      OT.demand(ref_net, token, **kw).dense_full())
    with pytest.raises(ValueError, match="skew"):
        T.demand(net, "skewed-alltoall:skew1.5")


@pytest.mark.parametrize("name", FABRICS)
def test_the_numpy_engine_matches_the_originals_chunked_pass(name):
    ref_net, net = _pair(name)
    for token in TOKENS:
        want = F.demand_edge_loads(ref_net, OT.demand(ref_net, token), source_chunk=100)
        got = G.demand_edge_loads(net, T.demand(net, token), source_chunk=100)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", FABRICS)
@pytest.mark.parametrize("token", TOKENS)
def test_torch_backend_matches_numpy_and_jax(token, name):
    """The port's torch backend on the CPU against the original's max link load
    through both of its backends (for alltoall and bisection on a healthy mesh
    or torus, both packages' symmetry-class fast path), a token, a spec and a
    Demand; for those two, the torch backend's chunked pass as well."""
    ref_net, net = _pair(name)
    got = G.max_link_load(net, token, source_chunk=200, backend="torch", device="cpu")
    for backend in ("numpy", "jax"):
        want = F.max_link_load(ref_net, token, backend=backend)
        assert got == pytest.approx(want, rel=RTOL), backend
    dem = T.demand(net, token)
    assert G.demand_max_link_load(net, dem, backend="torch", device="cpu") == pytest.approx(
        got, rel=RTOL)
    if token in ("alltoall", "bisection"):
        G.device_chunks = 0
        loads = G.demand_edge_loads(net, dem, source_chunk=200, backend="torch", device="cpu")
        assert G.device_chunks == -(-dem.n_sources // 200)
        for backend in ("numpy", "jax"):
            assert loads.max() == pytest.approx(F.max_link_load(ref_net, token, backend=backend),
                                                rel=RTOL), backend
    assert G.max_link_load(net, T.parse_traffic(token)) == G.demand_max_link_load(net, dem)


def test_max_link_load_keeps_its_dense_path():
    ref_net, net = _pair("torus8x8")
    dense = T.demand(net, "permutation:seed1").dense_full()
    assert G.max_link_load(net, dense) == F.max_link_load(ref_net, "permutation:seed1")
    assert G.demand_max_link_load(net, T._empty_demand(net), backend="torch",
                                  device="cpu") == 0.0


def test_demand_path_wants_a_gpu_unless_told_cpu(monkeypatch):
    net = G.build_hxmesh(2, 2, 4, 4)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.max_link_load(net, "skewed-alltoall:h8:seed3", backend="torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.demand_edge_loads(net, T.demand(net, "bisection"), backend="torch")
    with pytest.raises(ValueError, match="backend"):
        G.max_link_load(net, "bisection", backend="jax")
    built = []
    dense = G._dense_adjacency
    monkeypatch.setattr(G, "_dense_adjacency", lambda n, dev: built.append(dev) or dense(n, dev))
    G.demand_edge_loads(net, T.demand(net, "alltoall"), source_chunk=5, backend="torch",
                        device="cpu")
    assert built == [torch.device("cpu")]  # one adjacency for the 13 chunks
