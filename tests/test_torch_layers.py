"""The port's dense layers against the JAX package's, in float32.

Inputs are made with NumPy from a seed and handed to both.  Tolerance 2e-5
(rtol and atol), as the JAX package's own attention tests use: XLA on the CPU
and ATen sum in different orders, which moves fp32 results by a few ulp of
values of order one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

TOL = 2e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 24, 4, 16)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


ATTN_CASES = [(True, 0), (True, 16), (False, 0), (False, 16)]


@pytest.mark.parametrize("causal,window", ATTN_CASES)
def test_attention_dense_matches_jax(causal, window):
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, 2, 40, 4, 16), _rand(rng, 2, 40, 2, 16), _rand(rng, 2, 40, 2, 16)
    _close(TL.attention_dense(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window),
           JL.attention_dense(*map(jnp.asarray, (q, k, v)), causal=causal, window=window))


@pytest.mark.parametrize("causal,window", ATTN_CASES)
def test_attention_chunked_matches_jax(causal, window):
    rng = np.random.default_rng(2)
    # 40 keys in chunks of 16: the last chunk is padded and masked
    q, k, v = _rand(rng, 2, 40, 4, 16), _rand(rng, 2, 40, 2, 16), _rand(rng, 2, 40, 2, 16)
    t = TL.attention_chunked(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
                             chunk=16)
    j = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                             chunk=16)
    _close(t, j)


@pytest.mark.parametrize("length,window", [(1, 0), (9, 0), (16, 0), (12, 4)])
def test_attention_decode_matches_jax(length, window):
    rng = np.random.default_rng(3)
    q, kc, vc = _rand(rng, 2, 1, 4, 16), _rand(rng, 2, 16, 2, 16), _rand(rng, 2, 16, 2, 16)
    _close(TL.attention_decode(*map(torch.from_numpy, (q, kc, vc)), length, window=window),
           JL.attention_decode(*map(jnp.asarray, (q, kc, vc)), length, window=window))


@pytest.mark.parametrize("use_kernel,sk", [(False, 24), (False, 40), (True, 24)])
def test_attention_dispatch_matches_jax(use_kernel, sk):
    # chunk_threshold 32: 24 keys go dense, 40 go chunked; use_kernel takes the flash op
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 1, sk, 4, 16), _rand(rng, 1, sk, 2, 16), _rand(rng, 1, sk, 2, 16)
    kw = dict(causal=True, window=0, chunk_threshold=32, chunk=16, use_kernel=use_kernel)
    _close(TL.attention(*map(torch.from_numpy, (q, k, v)), **kw),
           JL.attention(*map(jnp.asarray, (q, k, v)), **kw))


def test_rmsnorm_and_layernorm_match_jax():
    rng = np.random.default_rng(5)
    x, g, b = _rand(rng, 3, 7, 64, scale=3.0), _rand(rng, 64, scale=0.1), _rand(rng, 64)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(g)))
    _close(TL.layernorm(*map(torch.from_numpy, (x, g, b))),
           JL.layernorm(*map(jnp.asarray, (x, g, b))))


def test_mlps_match_jax():
    rng = np.random.default_rng(6)
    x = _rand(rng, 2, 5, 32)
    wg, wu, wd = _rand(rng, 32, 48, scale=0.2), _rand(rng, 32, 48, scale=0.2), \
        _rand(rng, 48, 32, scale=0.2)
    bu, bd = _rand(rng, 48), _rand(rng, 32)
    _close(TL.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))),
           JL.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    _close(TL.gelu_mlp(*map(torch.from_numpy, (x, wu, bu, wd, bd))),
           JL.gelu_mlp(*map(jnp.asarray, (x, wu, bu, wd, bd))))


def test_chunked_attention_matches_dense():
    # port of tests/test_models.py::test_chunked_attention_matches_dense
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, 2, 64, 4, 16))
    k = torch.from_numpy(_rand(rng, 2, 64, 2, 16))
    v = torch.from_numpy(_rand(rng, 2, 64, 2, 16))
    for causal, window in [(True, 0), (True, 16), (False, 0)]:
        dense = TL.attention_dense(q, k, v, causal=causal, window=window)
        chunked = TL.attention_chunked(q, k, v, causal=causal, window=window, chunk=16)
        np.testing.assert_allclose(dense.numpy(), chunked.numpy(), rtol=2e-5, atol=2e-5)
