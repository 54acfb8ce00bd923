"""The port's audio family (whisper, encoder-decoder) against the JAX package's, on the CPU.

Weights are the JAX package's init (float32, or bfloat16 where the test says
so), moved into the port through ``repro_torch.testing.bridge``; tokens and
encoder frames come from the data pipelines (bit-identical) or NumPy.
Tolerances, and why:

* the frames: bit for bit (the port rounds NumPy's float32 draws to bfloat16
  as ml_dtypes does, and keeps them in float32);
* the encoder's output, a cross-attention block and the logits of the
  forward and of the decode steps, and the decode caches, in float32: rtol
  1e-4, atol 1e-4 of the largest magnitude, as ``tests/test_torch_transformer.py``
  (XLA and ATen sum the projections in other orders);
* in bfloat16, as ``tests/test_torch_ssm.py`` says: the result's relative
  L2 distance from JAX's float32 result on the same (bf16) weights and
  inputs at most twice that of JAX's bf16 result, and the dtypes equal.

Decode has no relation to the forward here: in both packages its
cross-attention reads the cache's ``xk``/``xv``, which nothing fills, so it
ignores the encoder (ROADMAP, reference behaviours).
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
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402

torch.set_num_threads(2)

SMOKE = get_config("whisper-tiny-smoke")  # 2 + 2 layers, d 64, H 4, D 16, enc_seq 16
# S 40 > 2·attn_chunk: the decoder's self-attention takes the chunked path
CHUNKED = dataclasses.replace(SMOKE, name="audio-chunked", attn_chunk=8)
# a learned-position table of 6 rows: decode clamps its row from step 6 on
SHORT = dataclasses.replace(SMOKE, name="audio-short", max_pos=6)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16_FACTOR = 2.0


def _jcfg(cfg):
    return JArchConfig(**dataclasses.asdict(cfg))


def _both(cfg, dtype=jnp.float32, seed=0):
    """(JAX params, port params) of the JAX init, bridged."""
    jparams = JT.init_params(_jcfg(cfg), jax.random.PRNGKey(seed), dtype=dtype)
    return jparams, bridge.params_from_numpy(jax.device_get(jparams))


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _batch(cfg, s=24, b=2, step=0):
    """(JAX batch, port batch) of the two pipelines."""
    jb = jpipe.make_batch(_jcfg(cfg), s, b, step=step)
    tb = tpipe.make_batch(cfg, s, b, step=step)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v) for k, v in tb.items()})


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want):
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


def _check(got, want, jfn, jparams, dtype):
    """fp32: ``_close``; bf16: ``_bf16_close`` beside ``jfn`` on float32 weights."""
    if dtype == "float32":
        _close(got, want)
    else:
        _bf16_close(got, want, jfn(_f32(jparams)))


def test_configs_are_the_jax_packages():
    for arch in ("whisper-tiny-smoke", "whisper-tiny"):
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))


# ---------------------------------------------------------------------------
# the frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,seq,batch,step,seed", [
    ("whisper-tiny-smoke", 8, 2, 0, 0),
    ("whisper-tiny-smoke", 16, 3, 5, 2),
    ("whisper-tiny", 4, 1, 1, 0),  # the full enc_seq (1500) x d_model (384)
])
def test_frames_are_jaxs_bit_for_bit(arch, seq, batch, step, seed):
    cfg = get_config(arch)
    want = jpipe.make_batch(jget_config(arch), seq, batch, step=step, seed=seed)
    got = tpipe.make_batch(cfg, seq, batch, step=step, seed=seed)
    assert sorted(got) == sorted(want) == ["encoder_frames", "labels", "tokens"]
    frames = got["encoder_frames"]
    assert frames.dtype == np.float32 and frames.shape == (batch, cfg.enc_seq, cfg.d_model)
    wantf = np.asarray(want["encoder_frames"]).astype(np.float32)
    np.testing.assert_array_equal(frames.view(np.uint32), wantf.view(np.uint32))
    # bfloat16 values: the low 16 bits are zero
    assert not (frames.view(np.uint32) & 0xFFFF).any()
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key], want[key])


def test_bf16_round_ties_to_even():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)  # bf16's spacing at 1
    x = np.array([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2.0 ** -20, -(one + ulp / 2)],
                 np.float32)
    got = tpipe.bf16_round(x)
    np.testing.assert_array_equal(got, np.array([one, one + 2 * ulp, one + ulp, -one], np.float32))


# ---------------------------------------------------------------------------
# the encoder and the cross-attention
# ---------------------------------------------------------------------------


def test_get_model_is_the_transformer():
    assert get_model(SMOKE) is TT and get_model(get_config("whisper-tiny")) is TT


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_layout_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    for cfg in (SMOKE, SHORT):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JT.init_params(_jcfg(cfg), jax.random.PRNGKey(0), dtype=jdt))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           TT.init_params(cfg, torch.Generator().manual_seed(0), tdt))
        assert got == want, cfg.name
    params = TT.init_params(SMOKE, torch.Generator().manual_seed(0), torch.float32)
    assert params["pos_embed"].shape == (SMOKE.max_pos, SMOKE.d_model)
    assert params["encoder"]["pos_embed"].shape == (SMOKE.enc_seq, SMOKE.d_model)
    assert {k for k in params["layers"] if k.startswith("x")} == {
        "xattn_norm", "xwq", "xwk", "xwv", "xwo"}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_matches_jax(dtype, remat):
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(SMOKE)
    jparams, tparams = _both(SMOKE, jdt)
    jb, tb = _batch(SMOKE)
    want = JT._encoder_forward(jcfg, jparams["encoder"], jb["encoder_frames"], remat)
    enc = tparams["encoder"]
    if remat:
        enc = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), enc)
    with torch.enable_grad():
        got = TT._encoder_forward(SMOKE, enc, tb["encoder_frames"], remat)
    assert got.dtype == tdt and got.shape == want.shape == (2, SMOKE.enc_seq, SMOKE.d_model)
    assert got.requires_grad == remat
    _check(got, want, lambda p: JT._encoder_forward(jcfg, p["encoder"],
                                                    jb["encoder_frames"], False),
           jparams, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_jax(dtype):
    # one decoder layer's cross-attention block: q from the decoder, k and v
    # from the encoder's output, not causal, nothing rotated
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(SMOKE)
    jparams, tparams = _both(SMOKE, jdt)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, SMOKE.d_model), dtype=np.float32)
    enc = rng.standard_normal((2, SMOKE.enc_seq, SMOKE.d_model), dtype=np.float32)

    def jblock(p):
        xp = {k[1:]: v[0] for k, v in p["layers"].items() if k in ("xwq", "xwk", "xwv", "xwo")}
        return JT._attn_block(jcfg, xp, jnp.asarray(x, xp["wq"].dtype), None, causal=False,
                              window=0, kv_seq=jnp.asarray(enc, xp["wq"].dtype))

    xp = {k[1:]: v[0] for k, v in tparams["layers"].items() if k in ("xwq", "xwk", "xwv", "xwo")}
    got = TT._attn_block(SMOKE, xp, torch.from_numpy(x).to(tdt), None, causal=False, window=0,
                         kv_seq=torch.from_numpy(enc).to(tdt))
    want = jblock(jparams)
    assert got.dtype == tdt and got.shape == want.shape == (2, 24, SMOKE.d_model)
    _check(got, want, jblock, jparams, dtype)


def test_cross_attention_sees_every_frame():
    # not causal: the first decoder position reads the last frame too (q scaled
    # down, so that the init's near-one-hot softmax spreads over the frames)
    _, tparams = _both(SMOKE)
    xp = {k[1:]: v[0] for k, v in tparams["layers"].items() if k in ("xwq", "xwk", "xwv", "xwo")}
    xp["wq"] = xp["wq"] * 1e-3
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 4, SMOKE.d_model), dtype=np.float32))
    enc = torch.from_numpy(rng.standard_normal((1, SMOKE.enc_seq, SMOKE.d_model),
                                               dtype=np.float32))
    moved = enc.clone()
    moved[:, -1] += 1.0
    a = TT._attn_block(SMOKE, xp, x, None, causal=False, window=0, kv_seq=enc)
    b = TT._attn_block(SMOKE, xp, x, None, causal=False, window=0, kv_seq=moved)
    assert not torch.allclose(a[:, 0], b[:, 0])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _forward(cfg, params, batch, remat, use_kernel):
    """The port's forward; with ``remat`` under autograd, so each layer is checkpointed."""
    if remat:
        params = tree_lib.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        logits, aux = TT.forward(cfg, params, batch["tokens"],
                                 encoder_frames=batch["encoder_frames"], remat=remat,
                                 use_kernel=use_kernel)
    assert logits.requires_grad == remat
    return logits.detach(), aux


@pytest.mark.parametrize("remat,use_kernel", [(False, False), (True, True)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", [SMOKE, CHUNKED], ids=lambda c: c.name)
def test_forward_matches_jax(cfg, dtype, remat, use_kernel):
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    jb, tb = _batch(cfg, s=40)

    def jforward(p, remat=remat):
        return JT.forward(jcfg, p, jb["tokens"], encoder_frames=jb["encoder_frames"],
                          remat=remat, use_kernel=use_kernel)[0]

    before = tfa.launches
    want = jforward(jparams)
    got, aux = _forward(cfg, tparams, tb, remat, use_kernel)
    assert tfa.launches == before  # CPU tensors take the plain version
    assert got.shape == want.shape == (2, 40, cfg.vocab) and got.dtype == tdt
    assert float(aux) == 0.0 and aux.dtype == torch.float32
    _check(got, want, functools.partial(jforward, remat=False), jparams, dtype)


def test_forward_needs_frames():
    params = TT.init_params(SMOKE, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="encoder frames"):
        TT.forward(SMOKE, params, torch.zeros((1, 4), dtype=torch.int32))


def test_learned_positions_reach_the_logits():
    # the decoder's pos_embed row s moves the logits at position s and after only
    params = TT.init_params(SMOKE, torch.Generator().manual_seed(0), torch.float32)
    _, tb = _batch(SMOKE, s=12)
    base, _ = TT.forward(SMOKE, params, tb["tokens"], encoder_frames=tb["encoder_frames"])
    params["pos_embed"][5] += 0.5
    moved, _ = TT.forward(SMOKE, params, tb["tokens"], encoder_frames=tb["encoder_frames"])
    torch.testing.assert_close(base[:, :5], moved[:, :5], rtol=0, atol=0)
    assert not torch.allclose(base[:, 5:], moved[:, 5:])


@pytest.mark.parametrize("max_len", [8, 32])
def test_init_cache_matches_jax(max_len):
    for dtype, (jdt, tdt) in DTYPES.items():
        want = JT.init_cache(_jcfg(SMOKE), 3, max_len, dtype=jdt)
        got = TT.init_cache(SMOKE, 3, max_len, dtype=tdt)
        assert sorted(got) == sorted(want) == ["k", "len", "v", "xk", "xv"]
        for k in ("k", "v", "xk", "xv"):
            assert tuple(got[k].shape) == want[k].shape and not got[k].any()
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert got["len"] == int(want["len"]) == 0
        assert got["xk"].shape[2] == SMOKE.enc_seq


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg,steps,max_len", [(SMOKE, 10, 12), (SHORT, 10, 8)],
                         ids=["smoke", "past-max-pos"])
def test_decode_steps_match_jax(cfg, steps, max_len, dtype):
    # SHORT: from step 6 the learned position clamps to row 5 (max_pos - 1), as
    # lax.dynamic_slice_in_dim clamps it, and from step 8 the K/V slot to 7
    jdt, tdt = DTYPES[dtype]
    jcfg = _jcfg(cfg)
    jparams, tparams = _both(cfg, jdt)
    _, tb = _batch(cfg, s=steps)
    toks = tb["tokens"].numpy()
    jstep = jax.jit(functools.partial(JT.decode_step, jcfg))
    jcache = JT.init_cache(jcfg, 2, max_len, dtype=jdt)
    jcache32 = JT.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    tcache = TT.init_cache(cfg, 2, max_len, dtype=tdt)
    got, want, want32 = [], [], []
    for t in range(steps):
        tok = toks[:, t:t + 1]
        w, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        g, out = TT.decode_step(cfg, tparams, tcache, torch.from_numpy(tok))
        assert out is tcache and g.dtype == tdt and g.shape == w.shape
        if dtype == "float32":
            _close(g, w)
        else:  # held over all the steps at once (tests/test_torch_hybrid.py)
            got.append(g)
            want.append(w)
            w32, jcache32 = jstep(_f32(jparams), jcache32, jnp.asarray(tok))
            want32.append(w32)
    if dtype == "bfloat16":
        _bf16_close(torch.stack(got), jnp.stack(want), jnp.stack(want32))
    assert tcache["len"] == int(jcache["len"]) == steps
    for k in ("k", "v", "xk", "xv"):
        assert str(tcache[k].dtype).split(".")[-1] == str(jcache[k].dtype)
        if dtype == "float32":
            _close(tcache[k], jcache[k])
    assert not tcache["xk"].any() and not tcache["xv"].any()  # never filled, as in JAX


def test_decode_clamps_the_learned_position():
    # past max_pos every step adds the last row: with the table's last row
    # moved, the steps from max_pos - 1 on move and the ones before do not
    params = TT.init_params(SHORT, torch.Generator().manual_seed(0), torch.float32)
    _, tb = _batch(SHORT, s=9)

    def run(p):
        cache = TT.init_cache(SHORT, 2, 9, dtype=torch.float32)
        return torch.stack([TT.decode_step(SHORT, p, cache, tb["tokens"][:, t:t + 1])[0]
                            for t in range(9)])

    base = run(params)
    params["pos_embed"][SHORT.max_pos - 1] += 0.5
    moved = run(params)
    last = SHORT.max_pos - 1
    torch.testing.assert_close(base[:last], moved[:last], rtol=0, atol=0)
    assert all(not torch.allclose(base[t], moved[t]) for t in range(last, 9))


def test_decode_cross_attention_adds_nothing():
    # the zero xk/xv give a uniform softmax over zero values: each layer's
    # cross-attention adds 0 @ xwo, so the steps do not depend on xwo
    params = TT.init_params(SMOKE, torch.Generator().manual_seed(0), torch.float32)
    _, tb = _batch(SMOKE, s=3)
    other = dict(params, layers=dict(params["layers"], xwo=torch.randn_like(
        params["layers"]["xwo"])))
    outs = []
    for p in (params, other):
        cache = TT.init_cache(SMOKE, 2, 4, dtype=torch.float32)
        outs.append(torch.stack([TT.decode_step(SMOKE, p, cache, tb["tokens"][:, t:t + 1])[0]
                                 for t in range(3)]))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_dense_lm_module_takes_frames():
    params = TT.init_params(SMOKE, torch.Generator().manual_seed(0), torch.float32)
    _, tb = _batch(SMOKE, s=8)
    want, _ = TT.forward(SMOKE, params, tb["tokens"], encoder_frames=tb["encoder_frames"])
    module = TT.DenseLM(SMOKE, params)
    assert "encoder.pos_embed" in module.state_dict() and "layers.xwq" in module.state_dict()
    got, _ = module(tb["tokens"], encoder_frames=tb["encoder_frames"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
