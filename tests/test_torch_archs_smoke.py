"""The port's twin of ``tests/test_archs_smoke.py``: every arch at its smoke size.

For the 10 ``ASSIGNED_ARCHS`` and gpt3-paper, through ``get_model`` and the
step factories, on the CPU:

* the forward's logits have the shape (B, S, vocab), no NaN, and agree with
  the JAX package's on the same (bridged, float32) weights and batch, within
  rtol 1e-4 and an atol of 1e-4 of the largest logit (XLA and ATen sum in
  other orders; the families' own test files hold the same);
* one train step (float32, remat, AdamW) gives a finite positive loss and
  moves every parameter leaf;
* two decode steps give next tokens (B, 1) in the vocab, no NaN, and
  ``len == 2``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_archs  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as steps_lib  # noqa: E402

torch.set_num_threads(2)

ARCHS = list_archs() + ["gpt3-paper"]


def _batch(cfg, s=16, b=2):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, s, b).items()}


def test_the_archs_are_the_jax_tests():
    assert list_archs() == jlist_archs() == ASSIGNED_ARCHS and len(ARCHS) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_no_nans(arch):
    cfg = get_config(arch, smoke=True)
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    jparams = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jbatch = {k: jnp.asarray(v) for k, v in jpipe.make_batch(jcfg, 16, 2).items()}
    want, _ = jget_model(jcfg).forward(jcfg, jparams, jbatch["tokens"], remat=False,
                                       **steps_lib.model_extras(jbatch))
    batch = _batch(cfg)
    params = bridge.params_from_numpy(jax.device_get(jparams))
    logits, aux = get_model(cfg).forward(cfg, params, batch["tokens"], remat=False,
                                         **steps_lib.model_extras(batch))
    assert logits.shape == (2, 16, cfg.vocab) and aux.shape == ()
    assert not torch.isnan(logits).any()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step(arch):
    cfg = get_config(arch, smoke=True)
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    before = tree_lib.tree_map(torch.clone, params)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10, schedule=cfg.schedule)
    step = steps_lib.make_train_step(cfg, ocfg, steps_lib.TrainOptions(remat=True))
    new_params, _, metrics = step(params, opt.init(params), _batch(cfg))
    loss = float(metrics["loss"])
    assert np.isfinite(loss) and loss > 0
    still = [i for i, (a, b) in enumerate(zip(tree_lib.leaves(new_params),
                                              tree_lib.leaves(before))) if torch.equal(a, b)]
    assert not still, f"leaves {still} did not move"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    cache = model.init_cache(cfg, 2, 32)
    serve = steps_lib.make_decode_step(cfg)
    nxt, cache = serve(params, cache, torch.zeros((2, 1), dtype=torch.int32))
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    nxt2, cache = serve(params, cache, nxt)
    assert cache["len"] == 2
    assert ((nxt2 >= 0) & (nxt2 < cfg.vocab)).all()
