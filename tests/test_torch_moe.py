"""The port's MoE family against the JAX package's, on the CPU, in float32.

Weights are the JAX package's (its float32 init, or NumPy draws from a seed),
moved into the port through ``repro_torch.testing.bridge``; inputs are made
with NumPy.  Routing is discontinuous: a near-tie at the top-k boundary, or a
position shifted by one at the capacity, moves a token's output by O(1).  So
each test first asserts that the routing agrees exactly (every (token,
choice) pair's expert and whether it fits the capacity, against the JAX
router and a loop over the pairs), and only then compares values:

* ``capacity``, ``_route``, ``moe_apply`` and ``moe_apply_gshard``: rtol
  1e-5 with an atol of 1e-5 of the largest value (a handful of float32
  roundings in a different order; the largest difference seen is ~1e-7 on
  outputs of ~0.3);
* the model's forward (logits and the aux loss) at the tolerance of
  ``tests/test_torch_transformer.py`` (rtol 1e-4, atol 1e-4 of the largest
  logit), after checking each layer's routing as above with a margin: the
  k-th and (k+1)-th router logits of every token differ by more than
  ``MARGIN``, 50 times the packages' float32 difference there (logits up to
  ~17, activations agreeing to ~1e-6 relative; the smallest gap seen is
  1.0e-2), so the JAX model routes its own activations the same way;
* decode against forward: the tolerance of ``tests/test_models.py``.

The expert-parallel ``moe_apply_ep`` and ``Comm.all_to_all`` are held in
``tests/test_torch_moe_ep.py``; one train step of a MoE config in
``tests/test_torch_train.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402

torch.set_num_threads(2)

MOE_SMOKE = ["moonshot-v1-16b-a3b-smoke", "dbrx-132b-smoke"]  # MHA; GQA (4 heads, 2 kv)
MARGIN = 1e-3
# (b, s, d, f, e, k, capacity factor): check_moe_ep's widths with no drops
# (cf = e); drops at cf 1.25; one expert a token; a sequence of 4100 that pads
# its second group of 4096 by 4092 tokens, dropping at cf 1.25
LAYER_CASES = {
    "nodrop": (2, 8, 16, 32, 8, 2, 8.0),
    "drop": (2, 64, 16, 32, 8, 2, 1.25),
    "top1": (3, 32, 16, 24, 4, 1, 1.0),
    "padded": (1, 4100, 16, 8, 4, 2, 1.25),
}


def _layer(case, seed=0):
    """x (B, S, D) and one layer's params as NumPy float32."""
    b, s, d, f, e, _, _ = LAYER_CASES[case]
    rng = np.random.default_rng(seed)
    w = lambda *shape, scale=0.1: (rng.standard_normal(shape) * scale).astype(np.float32)  # noqa: E731
    x = w(b, s, d, scale=1.0)
    return x, {"router": w(d, e, scale=0.5), "w_gate": w(e, d, f), "w_up": w(e, d, f),
               "w_down": w(e, f, d)}


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    atol = rtol * max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach().float()), want, rtol=rtol, atol=atol)


def _slots_by_loop(experts, n_experts, cap):
    """(keep, clamped position) of every (token, choice) pair of each group, by a
    loop: the pairs claim an expert's slots in token-major order."""
    g, t, k = experts.shape
    keep = np.zeros((g, t * k), bool)
    pos = np.zeros((g, t * k), np.int64)
    for gi in range(g):
        used = [0] * n_experts
        for i, ex in enumerate(experts[gi].reshape(-1)):
            keep[gi, i] = used[ex] < cap
            pos[gi, i] = min(used[ex], cap - 1)
            used[ex] += 1
    return keep, pos


def _assert_routing_agrees(xg, router, top_k, cap, margin=0.0):
    """The port's routing of the groups xg (G, T, D) is the JAX router's, and its
    capacity slots are the loop's; with ``margin``, no token's k-th and
    (k+1)-th router logits are closer than it.  Returns the port's routing."""
    gates, experts, aux = TM._route(torch.from_numpy(xg), torch.from_numpy(router), top_k)
    jg, je, ja = jax.vmap(lambda xx: JM._route(xx, jnp.asarray(router), top_k))(
        jnp.asarray(xg))
    np.testing.assert_array_equal(experts.numpy(), np.asarray(je))
    flat_e, pos_c, keep = TM._slots(experts, router.shape[1], cap)
    want_keep, want_pos = _slots_by_loop(np.asarray(je), router.shape[1], cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(pos_c.numpy(), want_pos)
    if margin and router.shape[1] > top_k:
        logits = np.sort(xg.astype(np.float64) @ router, -1)
        gap = logits[..., -top_k] - logits[..., -top_k - 1]
        assert gap.min() > margin, f"a near-tie in the routing: gap {gap.min():.3e}"
    return gates, experts, aux, (jg, ja)


@pytest.mark.parametrize("group,k,e,factor", [
    (2048, 6, 64, 1.25), (1, 6, 64, 1.25), (128, 6, 64, 11.0), (4096, 4, 16, 1.25),
    (16, 2, 4, 1.25), (3, 2, 8, 0.1), (8, 2, 8, 8.0), (2048, 6, 64, 1.0),
])
def test_capacity_matches_jax(group, k, e, factor):
    assert TM.capacity(group, k, e, factor) == JM.capacity(group, k, e, factor)


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_route_matches_jax(case):
    x, p = _layer(case)
    b, s, d, _, e, k, cf = LAYER_CASES[case]
    group = min(TM.GROUP_TOKENS, s)
    xg = np.pad(x, ((0, 0), (0, -s % group), (0, 0))).reshape(-1, group, d)
    gates, experts, aux, (jg, ja) = _assert_routing_agrees(
        xg, p["router"], k, TM.capacity(group, k, e, cf))
    assert experts.dtype == torch.int64 and gates.dtype == torch.float32
    _close(gates, jg)
    _close(aux, ja)
    # one group of (T, D), as the JAX function takes it
    g1, e1, a1 = TM._route(torch.from_numpy(x[0]), torch.from_numpy(p["router"]), k)
    jg1, je1, ja1 = JM._route(jnp.asarray(x[0]), jnp.asarray(p["router"]), k)
    np.testing.assert_array_equal(e1.numpy(), np.asarray(je1))
    _close(g1, jg1)
    _close(a1, ja1)


def test_route_breaks_ties_to_the_lower_expert():
    # a zero token (the padding of a group) has equal probabilities everywhere
    x = np.zeros((3, 16), np.float32)
    router = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    _, experts, _ = TM._route(torch.from_numpy(x), torch.from_numpy(router), 3)
    _, je, _ = JM._route(jnp.asarray(x), jnp.asarray(router), 3)
    assert experts.tolist() == [[0, 1, 2]] * 3 == np.asarray(je).tolist()


@pytest.mark.parametrize("fn", ["moe_apply", "moe_apply_gshard"])
@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_apply_matches_jax(case, fn):
    x, p = _layer(case)
    b, s, d, _, e, k, cf = LAYER_CASES[case]
    group = min(TM.GROUP_TOKENS, s)
    cap = TM.capacity(group, k, e, cf)
    xg = np.pad(x, ((0, 0), (0, -s % group), (0, 0))).reshape(-1, group, d)
    _, experts, _, _ = _assert_routing_agrees(xg, p["router"], k, cap)
    keep = TM._slots(experts, e, cap)[2]
    if case in ("drop", "padded"):
        assert not keep.all()  # the case drops (token, choice) pairs
    want, want_aux = getattr(JM, fn)(jnp.asarray(x), jax.tree.map(jnp.asarray, p), k, cf)
    got, aux = getattr(TM, fn)(torch.from_numpy(x), bridge.params_from_numpy(p), k, cf)
    assert got.shape == (b, s, d) and got.dtype == torch.float32 and aux.shape == ()
    _close(got, want)
    _close(aux, want_aux)


def test_moe_apply_bf16_keeps_the_router_in_fp32():
    x, p = _layer("drop")
    tp = bridge.params_from_numpy(p)
    tp16 = {k: v if k == "router" else v.bfloat16() for k, v in tp.items()}
    y, aux = TM.moe_apply(torch.from_numpy(x).bfloat16(), tp16, 2, 1.25)
    y32, aux32 = TM.moe_apply(torch.from_numpy(x), tp, 2, 1.25)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    # the routing reads the bf16 activations; the values agree to bf16 rounding
    assert float((y.float() - y32).abs().max()) < 3e-2 * float(y32.abs().max())


# ---------------------------------------------------------------------------
# the MoE family of models/transformer.py
# ---------------------------------------------------------------------------


def _both(cfg):
    """(JAX config, JAX params, port params) for one port config."""
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jparams, bridge.params_from_numpy(jax.device_get(jparams))


def _tokens(cfg, b=2, s=24, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s), dtype=np.int32)


def _close_logits(got, want):
    want = np.asarray(want, np.float32)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=1e-4, atol=tol)


class _Recorder:
    """Records the input and params of every MoE dispatch of the port's forward."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("moe_apply", "moe_apply_gshard"):
            fn = getattr(TM, name)

            def wrapped(x, params, top_k, cf, fn=fn, **layout):  # gshard's expert_spec
                self.calls.append((x.detach().numpy().copy(), params, top_k, cf))
                return fn(x, params, top_k, cf, **layout)

            monkeypatch.setattr(TM, name, wrapped)

    def assert_routing_agrees(self):
        for x, params, top_k, cf in self.calls:
            b, s, d = x.shape
            group = min(TM.GROUP_TOKENS, s)
            xg = np.pad(x, ((0, 0), (0, -s % group), (0, 0))).reshape(-1, group, d)
            router = params["router"].detach().numpy()
            _assert_routing_agrees(xg, router, top_k,
                                   TM.capacity(group, top_k, router.shape[1], cf), MARGIN)


def test_smoke_configs_are_the_jax_packages():
    for a in MOE_SMOKE + ["moonshot-v1-16b-a3b", "dbrx-132b"]:
        assert dataclasses.asdict(get_config(a)) == dataclasses.asdict(jget_config(a))


@pytest.mark.parametrize("arch", MOE_SMOKE)
def test_init_layout_matches_jax(arch):
    cfg = get_config(arch)
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jdtype))
        params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0), dtype)
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), params)
        assert got == want
        assert params["layers"]["moe"]["router"].dtype == torch.float32


def test_expert_stacks_are_drawn_a_layer_at_a_time():
    # dense_init's distribution (fan-in L), in a fixed order from the generator
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b-smoke"), n_layers=8, n_experts=16)
    a = TT.init_params(cfg, torch.Generator().manual_seed(3), torch.float32)["layers"]["moe"]
    b = TT.init_params(cfg, torch.Generator().manual_seed(3), torch.bfloat16)["layers"]["moe"]
    w = a["w_gate"]
    assert w.shape == (8, 16, 64, 32)
    assert abs(float(w.std()) - 8 ** -0.5) < 0.01 and abs(float(w.mean())) < 0.01
    torch.testing.assert_close(b["w_up"], a["w_up"].bfloat16(), rtol=0, atol=0)
    assert not torch.equal(w[0], w[1])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("moe_mode", ["tp", "gshard"])
@pytest.mark.parametrize("arch", MOE_SMOKE)
def test_moe_forward_matches_jax(arch, moe_mode, use_kernel, monkeypatch):
    cfg = dataclasses.replace(get_config(arch), moe_mode=moe_mode)
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg)
    want, want_aux = JT.forward(jcfg, jparams, jnp.asarray(toks), remat=False,
                                use_kernel=use_kernel)
    rec = _Recorder(monkeypatch)
    got, aux = TT.forward(cfg, tparams, torch.from_numpy(toks), use_kernel=use_kernel)
    assert len(rec.calls) == cfg.n_layers
    rec.assert_routing_agrees()
    assert got.shape == want.shape and aux.dtype == torch.float32 and float(aux) > 0
    _close_logits(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_forward_under_remat_and_autograd_matches_without():
    cfg = get_config("dbrx-132b-smoke")
    _, _, tparams = _both(cfg)
    toks = torch.from_numpy(_tokens(cfg))
    plain, plain_aux = TT.forward(cfg, tparams, toks, remat=False)
    with torch.enable_grad():
        leaf = tparams["layers"]["moe"]["router"].requires_grad_(True)
        remat, remat_aux = TT.forward(cfg, tparams, toks, remat=True)
        (remat.sum() + remat_aux).backward()
    torch.testing.assert_close(remat, plain, rtol=0, atol=0)
    torch.testing.assert_close(remat_aux, plain_aux, rtol=0, atol=0)
    assert leaf.grad is not None and float(leaf.grad.abs().sum()) > 0


def test_moe_mode_ep_in_forward_waits_for_the_sharding_slice():
    """The sharding slice brought the mesh: ``forward`` with ``moe_mode="ep"`` takes
    the rank's ``Comm`` as ``act_specs["mesh"]`` and raises without one.  On 2 rank
    threads it gives the tp forward's logits at a no-drop capacity factor."""
    from repro_torch.core.comm import LocalMesh

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b-smoke"), moe_mode="ep",
                              capacity_factor=8.0)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    toks = torch.from_numpy(_tokens(cfg, s=12))
    with pytest.raises(ValueError, match="act_specs"):
        TT.forward(cfg, params, toks)
    want, _ = TT.forward(dataclasses.replace(cfg, moe_mode="tp"), params, toks)
    mesh = LocalMesh((2,), ("model",), "cpu", timeout=60.0)
    for got, _ in mesh.run(lambda c: TT.forward(cfg, params, toks, act_specs={"mesh": c})):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
    # decode runs moe_apply whatever moe_mode, as in JAX
    cache = TT.init_cache(cfg, 1, 2, dtype=torch.float32)
    logits, _ = TT.decode_step(cfg, params, cache, torch.zeros((1, 1), dtype=torch.int32))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", MOE_SMOKE)
def test_moe_prefill_and_decode_steps_match_jax(arch):
    from repro.train import steps as jsteps
    from repro_torch.train import steps as tsteps

    cfg = get_config(arch)
    jcfg, jparams, tparams = _both(cfg)
    toks = _tokens(cfg, s=12)
    want = jsteps.make_prefill_step(jcfg, jsteps.TrainOptions(use_kernel=True, remat=False))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = tsteps.make_prefill_step(cfg, tsteps.TrainOptions(use_kernel=True))(
        tparams, {"tokens": torch.from_numpy(toks)})
    _close_logits(got, want)
    jcache = JT.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    tcache = TT.init_cache(cfg, 2, 16, dtype=torch.float32)
    for t in range(6):
        want, jcache = JT.decode_step(jcfg, jparams, jcache, jnp.asarray(toks[:, t:t + 1]))
        got, tcache = TT.decode_step(cfg, tparams, tcache, torch.from_numpy(toks[:, t:t + 1]))
        _close_logits(got, want)
    for name in ("k", "v"):
        _close_logits(tcache[name], jcache[name])


def test_decode_matches_forward():
    # port of tests/test_models.py::test_decode_matches_forward, its moe case
    # (capacity factor 8.0: no drops in the forward's groups of 8)
    cfg = ArchConfig("moe", "moe", 2, 64, 4, 2, 96, 256, n_experts=4, top_k=2,
                     capacity_factor=8.0)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    toks = torch.from_numpy(_tokens(cfg, s=8))
    full, _ = TT.forward(cfg, params, toks)
    cache = TT.init_cache(cfg, 2, 16, dtype=torch.float32)
    outs = []
    for t in range(8):
        lg, cache = TT.decode_step(cfg, params, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(full.numpy(), torch.stack(outs, 1).numpy(), rtol=2e-2, atol=2e-4)
