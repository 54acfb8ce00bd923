"""The port's VLM family (qwen2-vl, M-RoPE) against the JAX package's, on the CPU.

Weights are the JAX package's init (float32, or bfloat16 where the test says
so), moved into the port through ``repro_torch.testing.bridge``; tokens and
positions are made with NumPy from a seed.  Tolerances, and why:

* ``apply_mrope`` in float32: 2e-5 (rtol and atol), ``tests/test_torch_layers.py``'s
  for ``apply_rope`` (XLA and ATen take pow, sin and cos to within an ulp or
  two); at text positions it is ``apply_rope`` in the port, bit for bit;
* the forward's and decode steps' logits, and the decode caches, in float32:
  rtol 1e-4, atol 1e-4 of the largest magnitude, as
  ``tests/test_torch_transformer.py`` (XLA and ATen sum the projections in
  other orders);
* in bfloat16, as ``tests/test_torch_ssm.py`` says: the result's relative
  L2 distance from JAX's float32 result on the same (bf16) weights and
  inputs at most twice that of JAX's bf16 result, and the dtypes equal;
* decode against forward: the tolerance of ``tests/test_models.py``
  (rtol 2e-2, atol 2e-4);
* the flash op at a GQA group of 7: ``tests/test_kernels.py``'s (fp32 2e-5,
  bf16 3e-2), against the JAX kernel in Pallas interpret mode.
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402

torch.set_num_threads(2)

SMOKE = get_config("qwen2-vl-7b-smoke")  # H 4, KV 2, D 16, sections (4, 2, 2)
# qwen2-vl-7b's GQA group of 7 (H 28, KV 4) at smoke width: H 7, KV 1
GROUP7 = ArchConfig("vlm-group7", "vlm", 2, 112, 7, 1, 128, 256, head_dim=16,
                    rope_type="mrope", mrope_sections=(4, 2, 2))
# S 40 > 2·attn_chunk: the chunked attention path
CHUNKED = dataclasses.replace(SMOKE, name="vlm-chunked", attn_chunk=8)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_FACTOR = 2.0
TOL = 2e-5


def _jcfg(cfg):
    return JArchConfig(**dataclasses.asdict(cfg))


def _both(cfg, dtype=jnp.float32, seed=0):
    """(JAX params, port params) of the JAX init, bridged."""
    jparams = JT.init_params(_jcfg(cfg), jax.random.PRNGKey(seed), dtype=dtype)
    return jparams, bridge.params_from_numpy(jax.device_get(jparams))


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


def image_positions(b, s, seed=0):
    """(3, B, S) positions of a text prefix, one image and a text tail, Qwen2-VL's
    way: text tokens carry t == h == w counting on; the image's patches carry t
    constant over a frame and h, w walking its grid from the image's start;
    the tail counts on from the largest position before it.  The prefix length
    and the grid come from ``seed``."""
    rng = np.random.default_rng(seed)
    gh, gw = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    frames = max(1, min(2, (s - 2) // (gh * gw)))
    prefix = int(rng.integers(1, max(2, s - frames * gh * gw)))
    n_img = min(frames * gh * gw, s - prefix)
    idx = np.arange(n_img)
    t = prefix + idx // (gh * gw)
    hh = prefix + (idx // gw) % gh
    ww = prefix + idx % gw
    img = np.stack([t, hh, ww])
    start = int(img.max()) + 1
    tail = start + np.arange(s - prefix - n_img)
    text = np.arange(prefix)
    pos = np.concatenate([np.stack([text] * 3), img, np.stack([tail] * 3)], axis=1)
    return np.broadcast_to(pos[:, None, :], (3, b, s)).astype(np.int32).copy()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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


def test_configs_are_the_jax_packages():
    for arch in ("qwen2-vl-7b-smoke", "qwen2-vl-7b"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    for cfg in (get_config("qwen2-vl-7b"), SMOKE, GROUP7):
        assert sum(cfg.mrope_sections) == cfg.kq_head_dim // 2


def test_image_positions_differ_by_section():
    pos = image_positions(2, 24)
    assert pos.shape == (3, 2, 24)
    assert (pos[0] != pos[1]).any() and (pos[1] != pos[2]).any()
    assert (np.diff(pos[0], axis=-1) >= 0).all()  # t never goes back


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,d", [((4, 2, 2), 16), ((16, 24, 24), 128)])
@pytest.mark.parametrize("kind", ["seeded", "image", "text"])
def test_apply_mrope_matches_jax(sections, d, kind):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 24, 3, d), dtype=np.float32)
    if kind == "seeded":
        pos = rng.integers(0, 64, (3, 2, 24), dtype=np.int32)
    elif kind == "image":
        pos = image_positions(2, 24, seed=d)
    else:
        pos = np.broadcast_to(np.arange(24, dtype=np.int32), (3, 2, 24)).copy()
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if kind == "text":  # t == h == w: M-RoPE is RoPE
        rope = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]))
        assert torch.equal(got, rope)
    else:  # each section takes its own row of positions
        assert not torch.equal(got, TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0])))


def test_apply_mrope_keeps_bf16():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 2, 16), dtype=np.float32)).bfloat16()
    pos = torch.from_numpy(image_positions(2, 8, seed=3))
    got = TL.apply_mrope(x, pos, (4, 2, 2))
    want = TL.apply_mrope(x.float(), pos, (4, 2, 2)).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the flash op at a GQA group of 7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("s", [128, 200])
def test_flash_group7_matches_jax_kernel(s, dt, tol):
    # H 7, KV 1: query head h reads kv head h // 7, as qwen2-vl-7b's 28 / 4
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(s)
    q = rng.standard_normal((1, s, 7, 64), dtype=np.float32)
    k = rng.standard_normal((1, s, 1, 64), dtype=np.float32)
    v = rng.standard_normal((1, s, 1, 64), dtype=np.float32)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), True, 0)
    before = tfa.launches
    got = tops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=True)
    assert got.dtype == tdt and got.shape == (1, s, 7, 64) and tfa.launches == before
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_get_model_is_the_transformer():
    assert get_model(SMOKE) is TT and get_model(get_config("qwen2-vl-7b")) is TT


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_layout_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    for cfg in (SMOKE, GROUP7):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JT.init_params(_jcfg(cfg), jax.random.PRNGKey(0), dtype=jdt))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           TT.init_params(cfg, torch.Generator().manual_seed(0), tdt))
        assert got == want, cfg.name


def _forward(cfg, params, toks, pos, remat, use_kernel):
    """The port's forward; with ``remat`` under autograd, so each layer is checkpointed."""
    pos = None if pos is None else torch.from_numpy(pos)
    if remat:
        params = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), params)
        with torch.enable_grad():
            logits, aux = TT.forward(cfg, params, torch.from_numpy(toks), pos, remat=True,
                                     use_kernel=use_kernel)
        assert logits.requires_grad
        return logits.detach(), aux
    return TT.forward(cfg, params, torch.from_numpy(toks), pos, remat=False,
                      use_kernel=use_kernel)


@pytest.mark.parametrize("remat,use_kernel", [(False, False), (True, True)])
@pytest.mark.parametrize("positions", ["text", "image"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [SMOKE, GROUP7, CHUNKED], ids=lambda c: c.name)
def test_forward_matches_jax(cfg, dtype, positions, remat, use_kernel):
    # 40 tokens (past 2·attn_chunk for CHUNKED); "text" is forward's default
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    toks = _tokens(cfg, s=40)
    pos = image_positions(2, 40, seed=5) if positions == "image" else None
    jpos = None if pos is None else jnp.asarray(pos)
    before = tfa.launches
    want, waux = JT.forward(jcfg, jparams, jnp.asarray(toks), jpos, remat=remat,
                            use_kernel=use_kernel)
    got, aux = _forward(cfg, tparams, toks, pos, remat, use_kernel)
    assert tfa.launches == before  # CPU tensors take the plain version
    assert got.shape == want.shape and got.dtype == tdt
    assert float(aux) == float(waux) == 0.0 and aux.dtype == torch.float32
    if dtype == "float32":
        _close_logits(got, want)
    else:
        want32, _ = JT.forward(jcfg, _f32(jparams), jnp.asarray(toks), jpos, remat=False)
        _bf16_close(got, want, want32)


def test_positions_reach_the_logits():
    # the logits agree with the text positions' up to the first token whose
    # (t, h, w) leaves the text diagonal, and differ from there on
    _, tparams = _both(SMOKE)
    toks = torch.from_numpy(_tokens(SMOKE, s=24))
    pos = image_positions(2, 24, seed=2)
    first = int(np.argmax((pos[:, 0] != np.arange(24)).any(0)))
    assert first > 0
    text, _ = TT.forward(SMOKE, tparams, toks, remat=False)
    image, _ = TT.forward(SMOKE, tparams, toks, torch.from_numpy(pos), remat=False)
    torch.testing.assert_close(text[:, :first], image[:, :first], rtol=0, atol=0)
    assert not torch.allclose(text[:, first:], image[:, first:])


@pytest.mark.parametrize("max_len", [8, 32])
def test_init_cache_matches_jax(max_len):
    for dtype, (jdt, tdt) in DTYPES.items():
        want = JT.init_cache(_jcfg(SMOKE), 3, max_len, dtype=jdt)
        got = TT.init_cache(SMOKE, 3, max_len, dtype=tdt)
        assert sorted(got) == sorted(want) == ["k", "len", "v"]
        for k in ("k", "v"):
            assert tuple(got[k].shape) == want[k].shape and not got[k].any()
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert got["len"] == int(want["len"]) == 0


@pytest.mark.parametrize("positions", ["default", "image"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [SMOKE, GROUP7], ids=lambda c: c.name)
def test_decode_steps_match_jax(cfg, dtype, positions):
    # 12 steps into a cache of 10: the last two write the clamped last slot;
    # "image" passes each step its (3, B, 1) column of an image grid
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    toks = _tokens(cfg, s=12)
    grid = image_positions(2, 12, seed=7)
    jstep = jax.jit(functools.partial(JT.decode_step, jcfg))
    jcache = JT.init_cache(jcfg, 2, 10, dtype=jdt)
    jcache32 = JT.init_cache(jcfg, 2, 10, dtype=jnp.float32)
    tcache = TT.init_cache(cfg, 2, 10, dtype=tdt)
    got, want, want32 = [], [], []
    for t in range(12):
        tok = toks[:, t:t + 1]
        pos = None if positions == "default" else grid[:, :, t:t + 1]
        jpos = None if pos is None else jnp.asarray(pos)
        w, jcache = jstep(jparams, jcache, jnp.asarray(tok), jpos)
        g, out = TT.decode_step(cfg, tparams, tcache, torch.from_numpy(tok),
                                None if pos is None else torch.from_numpy(pos))
        assert out is tcache and g.dtype == tdt and g.shape == w.shape
        if dtype == "float32":
            _close_logits(g, w)
        else:  # held over all the steps at once (tests/test_torch_hybrid.py)
            got.append(g)
            want.append(w)
            w32, jcache32 = jstep(_f32(jparams), jcache32, jnp.asarray(tok), jpos)
            want32.append(w32)
    if dtype == "bfloat16":
        _bf16_close(torch.stack(got), jnp.stack(want), jnp.stack(want32))
    assert tcache["len"] == int(jcache["len"]) == 12
    for k in ("k", "v"):
        assert str(tcache[k].dtype).split(".")[-1] == str(jcache[k].dtype)
        if dtype == "float32":
            _close_logits(tcache[k], jcache[k])


def test_decode_window_is_read_for_the_vlm_family():
    # decode passes local_window to the attention for the vlm family only
    # (repro/models/transformer.py:330-331): a window of 4 moves the logits from
    # the fifth step on, and the same window on a dense config moves nothing
    toks = torch.from_numpy(_tokens(SMOKE, s=8))
    params = TT.init_params(SMOKE, torch.Generator().manual_seed(0), torch.float32)
    dense = ArchConfig("dense", "dense", 2, 64, 4, 2, 128, 512, head_dim=16)
    for cfg, moves in ((SMOKE, True), (dense, False)):
        outs = {}
        for window in (0, 4):
            c = dataclasses.replace(cfg, local_window=window)
            cache = TT.init_cache(c, 2, 8, dtype=torch.float32)
            outs[window] = torch.stack([TT.decode_step(c, params, cache, toks[:, t:t + 1])[0]
                                        for t in range(8)])
        torch.testing.assert_close(outs[0][:4], outs[4][:4], rtol=0, atol=0)
        assert torch.equal(outs[0][4:], outs[4][4:]) == (not moves), cfg.name


@pytest.mark.parametrize("cfg", [SMOKE, GROUP7], ids=lambda c: c.name)
def test_decode_matches_forward(cfg):
    # tests/test_models.py::test_decode_matches_forward at text positions
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    toks = torch.from_numpy(_tokens(cfg, s=8))
    full, _ = TT.forward(cfg, params, toks, remat=False)
    cache = TT.init_cache(cfg, 2, 16, dtype=torch.float32)
    outs = []
    for t in range(8):
        lg, cache = TT.decode_step(cfg, params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=2e-2, atol=2e-4)
