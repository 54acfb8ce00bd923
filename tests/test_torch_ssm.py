"""The port's SSM family (mamba2) against the JAX package's, on the CPU.

Weights are the JAX package's init (float32, or bfloat16 where the test says
so), moved into the port through ``repro_torch.testing.bridge``; inputs are
made with NumPy from a seed.  Tolerances, and why:

* ``causal_conv1d``: bit-exact in float32 and bfloat16 (the same products,
  summed in the same order);
* ``_segsum``: rtol 1e-6, atol 1e-6 (a cumulative sum in another order),
  ``-inf`` above the diagonal in the same places;
* ``ssd_chunked`` and ``_mix``'s states in float32: rtol 1e-4, atol 1e-5,
  the JAX package's own tolerance between the chunked and the sequential SSD
  (``tests/test_models.py::test_ssd_chunked_matches_sequential``); its port
  against an fp64 sequential recurrence the same;
* ``_mix``'s output and the forward's logits in float32: rtol 1e-4, atol
  1e-4 of the largest magnitude, as ``tests/test_torch_transformer.py``
  (XLA and ATen sum the projections in other orders);
* in bfloat16 every activation rounds to 8 bits, and the two packages do
  not round alike: XLA expands a bf16 sigmoid (so silu) into four ops, each
  rounded to bf16 (wrong in ~40 % of the elements), where ATen rounds once,
  correctly.  So a bf16 result is held to the JAX package's own bf16 error:
  its relative L2 distance from JAX's float32 result on the same (bf16)
  weights and inputs at most twice that of JAX's bf16 result, and the dtypes
  equal.  The ratio of the two is 0.7–1.4 over seeds at these sizes (a
  single step's output sums over the state with cancellation, so its error
  rests on few elements and varies most);
* decode against forward: the tolerance of ``tests/test_models.py``
  (rtol 2e-2, atol 2e-4); decode steps against JAX's as the forward.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402

torch.set_num_threads(2)

SMOKE = get_config("mamba2-130m-smoke")
# tests/test_models.py's consistency case: chunk 4, so 8 tokens span two chunks
SSM = ArchConfig("ssm", "ssm", 2, 64, 0, 0, 0, 256, ssm_state=16, ssm_head_dim=16,
                 ssm_chunk=4, rope_type="none")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_FACTOR = 2.0


def _jcfg(cfg):
    return JArchConfig(**dataclasses.asdict(cfg))


def _both(cfg, dtype=jnp.float32, seed=0):
    """(JAX params, port params) of the JAX init, bridged."""
    jparams = JM.init_params(_jcfg(cfg), jax.random.PRNGKey(seed), dtype=dtype)
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
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(jget_config("mamba2-130m-smoke"))
    assert dataclasses.asdict(get_config("mamba2-130m")) == dataclasses.asdict(
        jget_config("mamba2-130m"))
    assert TM.dims(SMOKE) == JM.dims(_jcfg(SMOKE))


# ---------------------------------------------------------------------------
# causal_conv1d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((2, 9, 12)), jdt)
    w = jnp.asarray(rng.standard_normal((4, 12)) * 0.3, jdt)
    state = jnp.asarray(rng.standard_normal((2, 3, 12)), jdt) if with_state else None
    want, want_state = JL.causal_conv1d(x, w, state)
    got, got_state = TL.causal_conv1d(_to_torch(x), _to_torch(w),
                                      None if state is None else _to_torch(state))
    assert got.dtype == got_state.dtype == tdt
    assert got_state.shape == want_state.shape == (2, 3, 12)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_state.float().numpy(), np.asarray(want_state, np.float32))


def test_causal_conv1d_state_carries_across_calls():
    # two calls with the state between them give the one call over both halves
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    whole, whole_state = TL.causal_conv1d(x, w)
    a, st = TL.causal_conv1d(x[:, :7], w)
    b, st = TL.causal_conv1d(x[:, 7:], w, st)
    torch.testing.assert_close(torch.cat([a, b], 1), whole, rtol=0, atol=0)
    torch.testing.assert_close(st, whole_state, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _ssd_inputs(b=2, s=24, h=3, p=4, n=8, seed=0):
    """The inputs of test_ssd_chunked_matches_sequential's shapes, drawn with NumPy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((h,)))).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, state


def _ssd_sequential(x, dt, A, B, C, state=None):
    """tests/test_models.py's fp64 recurrence, with an initial state."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    hstate = np.zeros((b, h, p, n)) if state is None else np.asarray(state, np.float64)
    x, dt, A, B, C = (np.asarray(a, np.float64) for a in (x, dt, A, B, C))
    ys = []
    for t in range(s):
        decay = np.exp(dt[:, t] * A)
        upd = np.einsum("bh,bn,bhp->bhpn", dt[:, t], B[:, t], x[:, t])
        hstate = hstate * decay[..., None, None] + upd
        ys.append(np.einsum("bn,bhpn->bhp", C[:, t], hstate))
    return np.stack(ys, 1), hstate


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(np.float32)
    want = np.asarray(JM._segsum(jnp.asarray(x)))
    got = TM._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 7, 8, 24])
def test_ssd_chunked_matches_jax(chunk, with_state):
    x, dt, A, B, C, state = _ssd_inputs()
    state = state if with_state else None
    want_y, want_st = JM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                                     init_state=None if state is None else jnp.asarray(state))
    got_y, got_st = TM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk,
                                   init_state=None if state is None else torch.from_numpy(state))
    assert got_y.dtype == got_st.dtype == torch.float32
    assert got_y.shape == want_y.shape and got_st.shape == want_st.shape
    _close(got_y, want_y)
    _close(got_st, want_st)


@pytest.mark.parametrize("chunk", [4, 7, 8, 24])
def test_ssd_chunked_matches_sequential(chunk):
    # port of tests/test_models.py::test_ssd_chunked_matches_sequential, and
    # with an initial state
    x, dt, A, B, C, state = _ssd_inputs(seed=1)
    for init in (None, state):
        y, st = TM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk,
                               init_state=None if init is None else torch.from_numpy(init))
        yr, str_ = _ssd_sequential(x, dt, A, B, C, init)
        _close(y, yr)
        _close(st, str_)


def test_ssd_chunked_returns_the_input_dtype():
    x, dt, A, B, C, _ = _ssd_inputs()
    y, st = TM.ssd_chunked(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, (dt, A)),
                           *(torch.from_numpy(a).bfloat16() for a in (B, C)), chunk=8)
    jy, jst = JM.ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(B, jnp.bfloat16), jnp.asarray(C, jnp.bfloat16), chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert str(jy.dtype) == "bfloat16" and str(jst.dtype) == "float32"
    # the same fp32 arithmetic on the same bf16 inputs; y rounds to bf16 once
    _close(st, jst)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), rtol=2 ** -7,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# _mix, both paths
# ---------------------------------------------------------------------------


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("single_step", [False, True])
def test_mix_matches_jax(single_step, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = SMOKE
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    jlp, tlp = _layer(jparams["layers"]), TL.unstack(tparams["layers"], cfg.n_layers)[0]
    di, h, p, n = TM.dims(cfg)
    rng = np.random.default_rng(2)
    b, s = 16, 1 if single_step else 19  # ragged: 19 tokens over chunks of 8
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, di + 2 * n)).astype(np.float32)
    ssm = (rng.standard_normal((b, h, p, n)) * 0.1).astype(np.float32)
    jx, jconv = jnp.asarray(x, jdt), jnp.asarray(conv, jdt)
    tx, tconv = _to_torch(jx), _to_torch(jconv)

    def run_jax(lp, xx, cc):
        return JM._mix(jcfg, lp, xx, cc, jnp.asarray(ssm), single_step=single_step)

    want = run_jax(jlp, jx, jconv)
    got = TM._mix(cfg, tlp, tx, tconv, torch.from_numpy(ssm), single_step=single_step)
    assert got[0].dtype == tdt and got[1].dtype == tdt and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
    if dtype == "float32":
        _close_logits(got[0], want[0])  # after w_out, as the forward's logits
        _close(got[1], want[1])
        _close(got[2], want[2])
        return
    want32 = run_jax(_f32(jlp), jx.astype(jnp.float32), jconv.astype(jnp.float32))
    _bf16_close(got[0], want[0], want32[0])
    np.testing.assert_array_equal(got[1].float().numpy(), np.asarray(want[1], np.float32))
    assert _rel_l2(got[2], want32[2]) <= BF16_FACTOR * _rel_l2(want[2], want32[2])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_layout_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    for cfg in (SMOKE, SSM):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JM.init_params(_jcfg(cfg), jax.random.PRNGKey(0), dtype=jdt))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           TM.init_params(cfg, torch.Generator().manual_seed(0), tdt))
        assert got == want, cfg.name
    # the deterministic leaves equal JAX's
    jp = JM.init_params(_jcfg(SMOKE), jax.random.PRNGKey(0), dtype=jdt)
    tp = TM.init_params(SMOKE, torch.Generator().manual_seed(0), tdt)
    for name in ("A_log", "D", "dt_bias"):
        _close(tp["layers"][name], jp["layers"][name], rtol=1e-7, atol=0)


def _forward(cfg, params, toks, remat):
    """The port's forward; with ``remat`` under autograd, so each layer is checkpointed."""
    if remat:
        params = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            logits, aux = TM.forward(cfg, params, torch.from_numpy(toks), remat=True)
        assert logits.requires_grad
        return logits.detach(), aux
    return TM.forward(cfg, params, torch.from_numpy(toks), remat=False)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [SMOKE, SSM], ids=lambda c: c.name)
def test_forward_matches_jax(cfg, dtype, remat):
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    toks = _tokens(cfg, s=21)  # ragged against both chunk sizes
    want, waux = JM.forward(jcfg, jparams, jnp.asarray(toks), remat=remat)
    got, aux = _forward(cfg, tparams, toks, remat)
    assert got.shape == want.shape and got.dtype == tdt
    assert float(aux) == float(waux) == 0.0 and aux.dtype == torch.float32
    if dtype == "float32":
        _close_logits(got, want)
    else:
        want32, _ = JM.forward(jcfg, _f32(jparams), jnp.asarray(toks), remat=False)
        _bf16_close(got, want, want32)


def test_get_model_is_mamba2():
    assert get_model(SMOKE) is TM


def test_init_cache_matches_jax():
    for dtype, (jdt, tdt) in DTYPES.items():
        want = JM.init_cache(_jcfg(SMOKE), 3, 16, dtype=jdt)
        got = TM.init_cache(SMOKE, 3, 16, dtype=tdt)
        assert sorted(got) == sorted(want)
        for k in ("conv", "ssm"):
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (k, dtype)
            assert not got[k].any()
        assert got["len"] == int(want["len"]) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_steps_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = SMOKE
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    toks = _tokens(cfg, s=10)
    jcache = JM.init_cache(jcfg, 2, 10, dtype=jdt)
    jcache32 = JM.init_cache(jcfg, 2, 10, dtype=jnp.float32)
    tcache = TM.init_cache(cfg, 2, 10, dtype=tdt)
    for t in range(10):
        tok = toks[:, t:t + 1]
        want, jcache = JM.decode_step(jcfg, jparams, jcache, jnp.asarray(tok))
        got, out = TM.decode_step(cfg, tparams, tcache, torch.from_numpy(tok))
        assert out is tcache and got.dtype == tdt
        if dtype == "float32":
            _close_logits(got, want)
        else:
            want32, jcache32 = JM.decode_step(jcfg, _f32(jparams), jcache32, jnp.asarray(tok))
            _bf16_close(got, want, want32)
    assert tcache["len"] == int(jcache["len"]) == 10
    if dtype == "float32":
        _close(tcache["conv"], jcache["conv"])
        _close(tcache["ssm"], jcache["ssm"])


def test_decode_matches_forward():
    # port of the ssm case of tests/test_models.py::test_decode_matches_forward
    params = TM.init_params(SSM, torch.Generator().manual_seed(0), dtype=torch.float32)
    toks = torch.from_numpy(_tokens(SSM, s=8))
    full, _ = TM.forward(SSM, params, toks, remat=False)
    cache = TM.init_cache(SSM, 2, 16, dtype=torch.float32)
    outs = []
    for t in range(8):
        lg, cache = TM.decode_step(SSM, params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=2e-2, atol=2e-4)
