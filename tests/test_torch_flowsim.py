"""The port's flow simulator (``repro_torch.core.flowsim``) against the JAX
package's ``repro.core.flowsim``, on the CPU.

* The copied builders give the original's directed edges and multiplicities,
  and ``traffic_matrix`` the original's dense ``alltoall`` traffic.
* The copied NumPy engine gives the original's distances, path counts, link
  loads and max link load exactly (the same float64 arithmetic).
* ``backend="torch"`` on ``device="cpu"`` agrees with the original's
  ``backend="jax"`` and ``backend="numpy"`` within rel 1e-5 (float32: the
  tolerance of ``tests/test_flowsim_vec.py``'s JAX check), on a torus, an
  HxMesh, a fat tree and an HxMesh with failed nodes (unreachable: D = -1),
  which each package builds with its own ``build_network`` (the same
  adjacency, dict for dict).
* Without ``device="cpu"`` the torch backend wants a GPU and raises here; an
  unknown backend raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import flowsim as F  # noqa: E402
from repro_torch.core import flowsim as G  # noqa: E402

NETS = {
    "torus8x8": lambda M: M.build_torus(8, 8),
    "hxmesh2x2-4x4": lambda M: M.build_hxmesh(2, 2, 4, 4),
    "fat_tree64": lambda M: M.build_fat_tree(64, 0.5),
    "hxmesh2x2-16x16": lambda M: M.build_hxmesh(2, 2, 16, 16),
}
FAILED = [5, 17, ("board", 1, 2)]  # two accelerators and a board of the 4x4 HxMesh


def _pair(name):
    if name == "failed":
        return (F.build_network(F.build_hxmesh(2, 2, 4, 4), failures=FAILED),
                G.build_network(G.build_hxmesh(2, 2, 4, 4), failures=FAILED))
    return NETS[name](F), NETS[name](G)


@pytest.mark.parametrize("name", [*NETS, "failed"])
def test_builders_match_the_original(name):
    ref, net = _pair(name)
    assert net.n_endpoints == ref.n_endpoints and net.n_nodes == ref.n_nodes
    assert net.meta == ref.meta
    assert net.adj == ref.adj
    for a, b in zip(net.directed_edges(), ref.directed_edges(), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [*NETS, "failed"])
def test_alltoall_and_the_numpy_engine_match_the_original(name):
    ref, net = _pair(name)
    T = G.traffic_matrix(net, "alltoall")
    np.testing.assert_array_equal(T, F.traffic_matrix(ref, "alltoall"))
    D, Np = G.shortest_paths(net)
    rD, rNp = F.shortest_paths(ref)
    np.testing.assert_array_equal(D, rD)
    np.testing.assert_array_equal(Np, rNp)
    np.testing.assert_array_equal(G.edge_loads(net, T, source_chunk=7),
                                  F.edge_loads(ref, T, source_chunk=7))
    assert G.max_link_load(net, T) == F.max_link_load(ref, T)


@pytest.mark.parametrize("name", ["torus8x8", "hxmesh2x2-4x4", "fat_tree64", "failed"])
def test_torch_backend_matches_jax_and_numpy(name):
    ref, net = _pair(name)
    T = G.traffic_matrix(net, "alltoall")
    want = F.max_link_load(ref, T)
    jx = F.max_link_load(ref, T, backend="jax")
    got = G.max_link_load(net, T, backend="torch", device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(jx, rel=1e-5)
    D, Np = G.shortest_paths(net, backend="torch", device="cpu")
    rD, rNp = F.shortest_paths(ref)
    np.testing.assert_array_equal(D, rD)
    np.testing.assert_allclose(Np, rNp, rtol=1e-6)
    assert Np.dtype == np.float64
    if name == "failed":
        assert (D == -1).any()
    loads = G.edge_loads(net, T, source_chunk=5, backend="torch", device="cpu")
    np.testing.assert_allclose(loads, F.edge_loads(ref, T), rtol=1e-5, atol=1e-6)


def test_torch_backend_wants_a_gpu_unless_told_cpu():
    net = G.build_torus(4, 4)
    T = G.traffic_matrix(net, "alltoall")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.max_link_load(net, T, backend="torch")
    with pytest.raises(ValueError, match="backend"):
        G.max_link_load(net, T, backend="jax")
    with pytest.raises(ValueError, match="rows"):
        G.max_link_load(net, T[:3])


def test_torch_backend_builds_the_adjacency_once_and_keeps_tf32_alone(monkeypatch):
    net = G.build_hxmesh(2, 2, 4, 4)
    T = G.traffic_matrix(net, "alltoall")
    built = []
    dense = G._dense_adjacency
    monkeypatch.setattr(G, "_dense_adjacency", lambda n, dev: built.append(dev) or dense(n, dev))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    loads = G.edge_loads(net, T, source_chunk=5, backend="torch", device="cpu")
    assert built == [torch.device("cpu")]  # one adjacency for the 13 chunks
    assert torch.backends.cuda.matmul.allow_tf32 is True
    np.testing.assert_allclose(loads, G.edge_loads(net, T), rtol=1e-5, atol=1e-6)
    # path counts are integers summed in float64: exact in float32
    np.testing.assert_array_equal(G.shortest_paths(net, backend="torch", device="cpu")[1],
                                  G.shortest_paths(net)[1])
