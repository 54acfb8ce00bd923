"""The port's dense transformer against the JAX package's, with bridged weights.

The JAX package initialises float32 weights; ``repro_torch.testing.bridge``
moves them into the port unchanged.  The same tokens, made with NumPy, go
through both.  Logits are compared at rtol 1e-4 and an atol of 1e-4 of the
largest logit: XLA on the CPU and ATen sum in different orders, and a few-ulp
difference in one layer grows through the stack (the largest difference seen
is ~6e-5 on logits of magnitude ~4.5, for internlm2-20b-smoke).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

torch.set_num_threads(2)

DENSE_SMOKE = ["llama3.2-3b-smoke", "minicpm-2b-smoke", "granite-8b-smoke",
               "internlm2-20b-smoke", "gpt3-paper-smoke"]
# a tied unembedding, and a vocab padded from 250 to 256 whose tail is masked
EXTRA = [
    ArchConfig("tied", "dense", 2, 64, 4, 2, 128, 250, head_dim=16, tie_embeddings=True),
    ArchConfig("padded", "dense", 2, 64, 4, 2, 128, 250, head_dim=16, vocab_pad_to=128),
    ArchConfig("tied-padded", "dense", 2, 64, 4, 2, 128, 250, head_dim=16,
               tie_embeddings=True, vocab_pad_to=128),
]
CONFIGS = [get_config(a) for a in DENSE_SMOKE] + EXTRA


def _both(cfg):
    """(JAX config, JAX params, port params) for one port config."""
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jparams, bridge.params_from_numpy(jax.device_get(jparams))


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=1e-4, atol=tol)


def test_smoke_configs_are_the_jax_packages():
    for a in DENSE_SMOKE:
        assert dataclasses.asdict(get_config(a)) == dataclasses.asdict(jget_config(a))


def test_init_layout_matches_jax():
    for cfg in CONFIGS:
        jcfg = JArchConfig(**dataclasses.asdict(cfg))
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                           TT.init_params(cfg, torch.Generator().manual_seed(0), torch.float32))
        assert got == want, cfg.name


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_forward_matches_jax(cfg, use_kernel):
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg)
    want, _ = JT.forward(jcfg, jparams, jnp.asarray(toks), remat=False, use_kernel=use_kernel)
    got, aux = TT.forward(cfg, tparams, torch.from_numpy(toks), use_kernel=use_kernel)
    assert got.shape == want.shape and float(aux) == 0.0
    _close(got, want)
    if cfg.vocab_pad_to and not cfg.tie_embeddings:
        assert (got[..., cfg.vocab:] == -1e30).all()


@pytest.mark.parametrize("cfg", [get_config("llama3.2-3b-smoke"), EXTRA[1]], ids=lambda c: c.name)
def test_prefill_step_matches_jax(cfg):
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg, s=40)
    jstep = jsteps.make_prefill_step(jcfg, jsteps.TrainOptions(use_kernel=True, remat=False))
    want = jstep(jparams, {"tokens": jnp.asarray(toks)})
    step = tsteps.make_prefill_step(cfg, tsteps.TrainOptions(use_kernel=True))
    before = tfa.launches
    got = step(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, want.shape[-1]) and tfa.launches == before
    _close(got, want)


@pytest.mark.parametrize("cfg", CONFIGS[:2] + EXTRA[:1], ids=lambda c: c.name)
def test_decode_steps_match_jax(cfg):
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg, s=6)
    jcache = JT.init_cache(jcfg, 2, 8, dtype=jnp.float32)
    tcache = TT.init_cache(cfg, 2, 8, dtype=torch.float32)
    for t in range(6):
        want, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, tcache = TT.decode_step(cfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want)
    assert tcache["len"] == int(jcache["len"]) == 6
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("cfg", [
    ArchConfig("tiny", "dense", 2, 64, 4, 2, 128, 256),
    ArchConfig("tiny-moe", "moe", 2, 64, 4, 2, 96, 256, n_experts=4, top_k=2),
], ids=lambda c: c.name)
def test_decode_past_the_cache_end_matches_jax(cfg):
    # a cache of 2 slots and 3 steps: JAX's dynamic_update_slice clamps the
    # third write to the last slot, while the length and RoPE position go on
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg, s=3)
    jcache = JT.init_cache(jcfg, 2, 2, dtype=jnp.float32)
    tcache = TT.init_cache(cfg, 2, 2, dtype=torch.float32)
    for t in range(3):
        want, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, tcache = TT.decode_step(cfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        _close(got, want)
    assert tcache["len"] == int(jcache["len"]) == 3
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_decode_step_tokens_match_jax():
    cfg = get_config("llama3.2-3b-smoke")
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg, s=1)
    jcache, tcache = JT.init_cache(jcfg, 2, 4, jnp.float32), TT.init_cache(cfg, 2, 4, torch.float32)
    jtok, _ = jsteps.make_decode_step(jcfg)(jparams, jcache, jnp.asarray(toks))
    ttok, _ = tsteps.make_decode_step(cfg)(tparams, tcache, torch.from_numpy(toks))
    assert ttok.dtype == torch.int32 and ttok.shape == (2, 1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_decode_matches_forward():
    # port of tests/test_models.py::test_decode_matches_forward (dense case)
    cfg = ArchConfig("dense", "dense", 2, 64, 4, 2, 128, 256)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    toks = torch.from_numpy(_tokens(cfg, s=8))
    full, _ = TT.forward(cfg, params, toks)
    cache = TT.init_cache(cfg, 2, 16, dtype=torch.float32)
    outs = []
    for t in range(8):
        lg, cache = TT.decode_step(cfg, params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=2e-2, atol=2e-4)


def test_dense_lm_module_delegates():
    cfg = get_config("llama3.2-3b-smoke")
    _, jparams, tparams = _both(cfg)
    model = TT.DenseLM(cfg, tparams)
    assert "layers.wq" in model.state_dict() and "final_norm.scale" in model.state_dict()
    toks = torch.from_numpy(_tokens(cfg))
    want, _ = TT.forward(cfg, tparams, toks)
    got, _ = model(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
