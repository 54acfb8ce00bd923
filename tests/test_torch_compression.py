"""The port's top-k gradient compression against ``repro.core.compression``.

On one device: ``topk_compress`` (the (index, value) pairs, compared as sets
sorted by index, since ``torch.topk`` promises no order among ties where
``lax.top_k`` puts the lower index first), its residual and three steps of
error feedback, ``decompress`` with duplicate indices, ``compression_ratio``.
Over 16 ``LocalMesh`` ranks: ``check_compression``'s mass conservation
(``tests/multidevice_checks.py``), and the train step's ``sync="auto"``
ignoring ``compress_k`` as the JAX step does.  Tolerances: 1e-6 for the
single-device float32 arithmetic, 1e-4 / 1e-5 for the mass check (as there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as steps_lib  # noqa: E402

torch.set_num_threads(1)


def _sorted_pairs(vals, idx):
    vals, idx = np.asarray(vals), np.asarray(idx).astype(np.int64)
    order = np.argsort(idx)
    return idx[order], vals[order]


@pytest.mark.parametrize("shape,k", [((64,), 8), ((16, 64), 8), ((3, 5, 7), 1), ((33,), 33)])
def test_topk_compress_matches_jax(shape, k):
    rng = np.random.default_rng(k)
    g = rng.standard_normal(shape).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) * 0.1
    jv, ji, jst = jcomp.topk_compress(jnp.asarray(g), jcomp.CompressionState(jnp.asarray(res)), k)
    tv, ti, tst = comp.topk_compress(torch.from_numpy(g), comp.CompressionState(
        torch.from_numpy(res)), k)
    want_i, want_v = _sorted_pairs(jv, ji)
    got_i, got_v = _sorted_pairs(tv, ti)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    assert tst.residual.shape == shape
    np.testing.assert_allclose(tst.residual.numpy(), np.asarray(jst.residual), rtol=1e-6)


def test_error_feedback_over_three_steps_matches_jax():
    rng = np.random.default_rng(7)
    grads = [rng.standard_normal((8, 16)).astype(np.float32) for _ in range(3)]
    jst = jcomp.init_state(jnp.asarray(grads[0]))
    tst = comp.init_state(torch.from_numpy(grads[0]))
    for g in grads:
        old = tst.residual
        jv, ji, jst = jcomp.topk_compress(jnp.asarray(g), jst, 5)
        tv, ti, tst = comp.topk_compress(torch.from_numpy(g), tst, 5)
        np.testing.assert_array_equal(_sorted_pairs(tv, ti)[0], _sorted_pairs(jv, ji)[0])
        np.testing.assert_allclose(tst.residual.numpy(), np.asarray(jst.residual), rtol=1e-6)
        # nothing is lost: what is sent plus the new residual is the gradient plus the old
        sent = comp.decompress(tv, ti, (8, 16))
        assert torch.count_nonzero(sent).item() == 5
        torch.testing.assert_close(sent + tst.residual, torch.from_numpy(g) + old)


def test_decompress_adds_duplicate_indices_like_jax():
    vals = np.array([1.5, -2.0, 0.25, 4.0, 1.0], np.float32)
    idx = np.array([3, 0, 3, 7, 3], np.int32)
    want = jcomp.decompress(jnp.asarray(vals), jnp.asarray(idx), (2, 4))
    got = comp.decompress(torch.from_numpy(vals), torch.from_numpy(idx).long(), (2, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,d", [(10**6, 100, 16), (3_607_000_000, 1000, 16), (512, 8, 4)])
def test_compression_ratio_matches_jax(n, k, d):
    assert comp.compression_ratio(n, k, d) == jcomp.compression_ratio(n, k, d)
    assert comp.compression_ratio(n, k, d, 2) == jcomp.compression_ratio(n, k, d, 2)


def test_sparse_allreduce_conserves_mass_over_16_ranks():
    # check_compression of tests/multidevice_checks.py, on 16 LocalMesh ranks
    g = np.random.default_rng(0).standard_normal((16, 64)).astype(np.float32)
    mesh = make_test_mesh((16,), ("d",), "cpu")

    def f(c, gs):
        out, st = comp.sparse_allreduce(c, gs, comp.init_state(gs), 8, "d")
        return out, st.residual

    res = mesh.run(f, [torch.from_numpy(row) for row in g])
    reduced = res[0][0].numpy()
    for out, _ in res:  # every rank holds the same reduced vector
        np.testing.assert_array_equal(out.numpy(), reduced)
    resid_sum = np.sum([r.numpy() for _, r in res], axis=0)
    np.testing.assert_allclose(reduced + resid_sum / 16, g.mean(0), rtol=1e-4, atol=1e-5)
    assert mesh.stats.all_gather_calls == 32 and not mesh.stats.bytes


def test_auto_sync_ignores_compress_k_as_jax_does():
    cfg = ArchConfig("tiny", "dense", 2, 32, 4, 2, 64, 128)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 8, 16).items()}
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    outs = []
    for k in (0, 8):
        params = TT.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
        step = steps_lib.make_train_step(cfg, ocfg, steps_lib.TrainOptions(
            remat=False, compress_k=k))
        outs.append(step(params, opt.init(params), batch))
    (p0, _, m0), (p1, _, m1) = outs
    assert float(m0["loss"]) == float(m1["loss"])
    for a, b in zip(tree_lib.leaves(p0), tree_lib.leaves(p1)):
        assert torch.equal(a, b)
