"""The port's hybrid family (recurrentgemma) against the JAX package's, on the CPU.

Weights are the JAX package's init (float32, or bfloat16 where the test says
so), moved into the port through ``repro_torch.testing.bridge``; inputs are
made with NumPy from a seed.  Tolerances, and why:

* ``rglru`` and ``rglru_step`` in float32: rtol 1e-5, atol 1e-6, the JAX
  package's own tolerance between its scan and its step
  (``tests/test_models.py::test_rglru_scan_matches_step``).  The port's
  log-depth scan combines in another order than ``lax.associative_scan``,
  so the two differ by rounding only;
* the forward's and decode steps' logits, and the decode caches, in float32:
  rtol 1e-4, atol 1e-4 of the largest magnitude, as
  ``tests/test_torch_transformer.py`` (XLA and ATen sum the projections in
  other orders);
* in bfloat16, as ``tests/test_torch_ssm.py`` says: the result's relative
  L2 distance from JAX's float32 result on the same (bf16) weights and
  inputs at most twice that of JAX's bf16 result, and the dtypes equal;
* decode against forward: the tolerance of ``tests/test_models.py``
  (rtol 2e-2, atol 2e-4).

The attention layers use the plain attention (dense, or chunked beyond
``2·attn_chunk`` keys) with the local window, as JAX's; the window is passed
(S > ``local_window``) in the forward and wrapped in decode's rolling cache.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models import recurrentgemma as JR  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import recurrentgemma as TR  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402

torch.set_num_threads(2)

SMOKE = get_config("recurrentgemma-9b-smoke")  # 5 layers: one block and a tail of 2
NO_TAIL = dataclasses.replace(SMOKE, name="hybrid-6", n_layers=6)  # two blocks
# S 40 > 2·attn_chunk: the chunked attention path, with the window of 16
CHUNKED = dataclasses.replace(SMOKE, name="hybrid-chunked", attn_chunk=8)
# tests/test_models.py's consistency case
HYBRID = ArchConfig("hybrid", "hybrid", 5, 64, 4, 1, 128, 256, local_window=16,
                    attention_period=3)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_FACTOR = 2.0


def _jcfg(cfg):
    return JArchConfig(**dataclasses.asdict(cfg))


def _both(cfg, dtype=jnp.float32, seed=0):
    """(JAX params, port params) of the JAX init, bridged."""
    jparams = JR.init_params(_jcfg(cfg), jax.random.PRNGKey(seed), dtype=dtype)
    return jparams, bridge.params_from_numpy(jax.device_get(jparams))


def _to_torch(a):
    return bridge.params_from_numpy(np.asarray(jax.device_get(a)))


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().double().numpy(), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=1e-4, atol=tol)


def _bf16_close(got, want16, want32):
    """``got`` (bf16) as near JAX's float32 result as JAX's bf16 one, within
    BF16_FACTOR (module docstring)."""
    assert got.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    floor = _rel_l2(want16.astype(jnp.float32), want32)
    err = _rel_l2(got.detach().float().numpy(), want32)
    assert err <= BF16_FACTOR * floor, (err, floor)


def test_smoke_config_is_the_jax_packages():
    for arch in ("recurrentgemma-9b-smoke", "recurrentgemma-9b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _lru_params(d, dtype=jnp.float32, seed=1):
    """test_rglru_scan_matches_step's weights (scale 0.1), drawn with NumPy."""
    rng = np.random.default_rng(seed)
    return {"w_a": jnp.asarray(rng.standard_normal((d, d)) * 0.1, dtype),
            "w_i": jnp.asarray(rng.standard_normal((d, d)) * 0.1, dtype),
            "lambda_p": jnp.asarray(0.5 + 0.5 * rng.standard_normal((d,)), jnp.float32)}


def test_linear_scan_is_the_recurrence():
    rng = np.random.default_rng(0)
    for s in (1, 2, 5, 16, 37):
        a = torch.from_numpy(rng.uniform(0, 1, (2, s, 3)))
        b = torch.from_numpy(rng.standard_normal((2, s, 3)))
        h, want = torch.zeros(2, 3, dtype=torch.float64), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(TR._linear_scan(a, b), torch.stack(want, 1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [1, 16, 37])
def test_rglru_matches_jax(s, with_h0, dtype):
    jdt, tdt = DTYPES[dtype]
    d = 16
    rng = np.random.default_rng(s)
    lp = _lru_params(d, jdt)
    x = jnp.asarray(rng.standard_normal((2, s, d)), jdt)
    h0 = jnp.asarray(rng.standard_normal((2, d)), jnp.float32) if with_h0 else None
    want, want_h = JR.rglru(x, lp, h0)
    got, got_h = TR.rglru(_to_torch(x), {k: _to_torch(v) for k, v in lp.items()},
                          None if h0 is None else _to_torch(h0))
    assert got.dtype == tdt and got_h.dtype == torch.float32 and got.shape == want.shape
    if dtype == "float32":
        _close(got, want, rtol=1e-5, atol=1e-6)
        _close(got_h, want_h, rtol=1e-5, atol=1e-6)
        return
    # the same float32 arithmetic on the same bf16 inputs; h rounds to bf16 once
    _close(got_h, want_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_step_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    d = 16
    rng = np.random.default_rng(4)
    lp = _lru_params(d, jdt)
    x = jnp.asarray(rng.standard_normal((3, 1, d)), jdt)
    h0 = jnp.asarray(rng.standard_normal((3, d)), jnp.float32)
    want, want_h = JR.rglru_step(x, lp, h0)
    got, got_h = TR.rglru_step(_to_torch(x), {k: _to_torch(v) for k, v in lp.items()},
                               _to_torch(h0))
    assert got.dtype == tdt and got_h.dtype == torch.float32 and got.shape == (3, 1, d)
    _close(got_h, want_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7 if dtype == "bfloat16" else 1e-5, atol=1e-6)


def test_rglru_scan_matches_step():
    # port of tests/test_models.py::test_rglru_scan_matches_step
    b, s, d = 2, 8, 16
    lp = {k: _to_torch(v) for k, v in _lru_params(d).items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((b, s, d)).astype(np.float32))
    y_full, hfin = TR.rglru(x, lp)
    h = torch.zeros((b, d))
    ys = []
    for t in range(s):
        yt, h = TR.rglru_step(x[:, t:t + 1], lp, h)
        ys.append(yt[:, 0])
    np.testing.assert_allclose(y_full.numpy(), torch.stack(ys, 1).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hfin.numpy(), h.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_layout_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    for cfg in (SMOKE, NO_TAIL, dataclasses.replace(SMOKE, tie_embeddings=True)):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JR.init_params(_jcfg(cfg), jax.random.PRNGKey(0), dtype=jdt))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           TR.init_params(cfg, torch.Generator().manual_seed(0), tdt))
        assert got == want, cfg.name
    assert "tail" not in TR.init_params(NO_TAIL, torch.Generator().manual_seed(0))


def _forward(cfg, params, toks, remat):
    """The port's forward; with ``remat`` under autograd, so each block is checkpointed."""
    if remat:
        params = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            logits, aux = TR.forward(cfg, params, torch.from_numpy(toks), remat=True,
                                     use_kernel=True)
        assert logits.requires_grad
        return logits.detach(), aux
    return TR.forward(cfg, params, torch.from_numpy(toks), remat=False)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [SMOKE, NO_TAIL, CHUNKED], ids=lambda c: c.name)
def test_forward_matches_jax(cfg, dtype, remat):
    # 40 tokens: past the window of 16 (and past 2·attn_chunk for CHUNKED)
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    toks = _tokens(cfg, s=40)
    want, waux = JR.forward(jcfg, jparams, jnp.asarray(toks), remat=remat)
    got, aux = _forward(cfg, tparams, toks, remat)
    assert got.shape == want.shape and got.dtype == tdt
    assert float(aux) == float(waux) == 0.0 and aux.dtype == torch.float32
    if dtype == "float32":
        _close_logits(got, want)
    else:
        want32, _ = JR.forward(jcfg, _f32(jparams), jnp.asarray(toks), remat=False)
        _bf16_close(got, want, want32)


def test_the_window_reaches_the_logits():
    # the forward's window mask is in force: with a window of 40 in place of 16
    # the first 16 positions, which see all their keys either way, are the same
    # and the later ones are not
    _, tparams = _both(SMOKE)
    toks = torch.from_numpy(_tokens(SMOKE, s=40))
    local, _ = TR.forward(SMOKE, tparams, toks, remat=False)
    wide, _ = TR.forward(dataclasses.replace(SMOKE, local_window=40), tparams, toks, remat=False)
    torch.testing.assert_close(local[:, :16], wide[:, :16], rtol=0, atol=0)
    assert not torch.allclose(local[:, 16:], wide[:, 16:])


def test_get_model_is_recurrentgemma():
    assert get_model(SMOKE) is TR


@pytest.mark.parametrize("max_len", [8, 32])
def test_init_cache_matches_jax(max_len):
    for cfg in (SMOKE, NO_TAIL):
        for dtype, (jdt, tdt) in DTYPES.items():
            want = JR.init_cache(_jcfg(cfg), 3, max_len, dtype=jdt)
            got = TR.init_cache(cfg, 3, max_len, dtype=tdt)
            assert sorted(got) == sorted(want)
            for k in ("conv", "lru", "k", "v"):
                assert tuple(got[k].shape) == want[k].shape, (cfg.name, k)
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (k, dtype)
                assert not got[k].any()
            assert got["len"] == int(want["len"]) == 0
            assert got["k"].shape[2] == min(cfg.local_window, max_len)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [SMOKE, NO_TAIL], ids=lambda c: c.name)
def test_decode_steps_match_jax_past_the_window(cfg, dtype):
    # window 16, cache 32 (so the window of 16 slots), 26 steps: the rolling
    # slot wraps at step 16 and the first 10 slots are written twice
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    toks = _tokens(cfg, s=26)
    jstep = jax.jit(functools.partial(JR.decode_step, jcfg))
    jcache = JR.init_cache(jcfg, 2, 32, dtype=jdt)
    jcache32 = JR.init_cache(jcfg, 2, 32, dtype=jnp.float32)
    tcache = TR.init_cache(cfg, 2, 32, dtype=tdt)
    assert tcache["k"].shape[2] == 16
    got, want, want32 = [], [], []
    for t in range(26):
        tok = toks[:, t:t + 1]
        w, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        g, out = TR.decode_step(cfg, tparams, tcache, torch.from_numpy(tok))
        assert out is tcache and g.dtype == tdt and g.shape == w.shape
        if dtype == "float32":
            _close_logits(g, w)
        else:
            # bf16 is held over all the steps' logits at once: one step's
            # error in either package swings 5x from step to step (from 1 %
            # to 15 %), and its mean is the measure of the dtype flow
            got.append(g)
            want.append(w)
            w32, jcache32 = jstep(_f32(jparams), jcache32, jnp.asarray(tok))
            want32.append(w32)
    if dtype == "bfloat16":
        _bf16_close(torch.stack(got), jnp.stack(want), jnp.stack(want32))
    assert tcache["len"] == int(jcache["len"]) == 26
    for k in ("conv", "lru", "k", "v"):
        assert str(tcache[k].dtype).split(".")[-1] == str(jcache[k].dtype)
        if dtype == "float32":
            _close_logits(tcache[k], jcache[k])


@pytest.mark.parametrize("s,max_len", [(8, 16), (24, 32)])
def test_decode_matches_forward(s, max_len):
    # port of the hybrid case of tests/test_models.py::test_decode_matches_forward
    # (8 tokens, cache 16), and past the window: 24 tokens, window 16, cache 32
    params = TR.init_params(HYBRID, torch.Generator().manual_seed(0), dtype=torch.float32)
    toks = torch.from_numpy(_tokens(HYBRID, s=s))
    full, _ = TR.forward(HYBRID, params, toks, remat=False)
    cache = TR.init_cache(HYBRID, 2, max_len, dtype=torch.float32)
    outs = []
    for t in range(s):
        lg, cache = TR.decode_step(HYBRID, params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=2e-2, atol=2e-4)
