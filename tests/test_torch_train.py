"""The port's training slice against the JAX package's, on the CPU.

Weights are the JAX package's float32 init, moved into the port through
``repro_torch.testing.bridge``; batches come from the (bit-identical) data
pipelines.  Tolerances, and why:

* loss, grad norm and gradients: rtol 1e-4, atol 1e-4 of the leaf's largest
  magnitude (XLA on the CPU and ATen sum in different orders, float32);
* lr: rtol 1e-6 (a few float32 operations on a scalar);
* updated parameters after one AdamW step: the first update is
  lr·(u(g) + wd·p) with u(g) = g/(|g| + eps), about ±lr wherever |g| ≫ eps.
  u is steep near 0: for two gradients g1, g2 of one sign
  |u(g1) − u(g2)| = eps·|g1 − g2| / ((|g1| + eps)(|g2| + eps)), and across a
  sign change it is up to 2.  So a gradient element of ~1e-6 that differs in
  its few-ulp-of-the-leaf's-largest digits (allowed above) moves the two
  parameters apart by ~1e-6.  Each element is held to lr times that bound,
  computed from the clipped gradient each package used (m / (1 − b1) after
  one step), plus rtol 1e-6 and atol 1e-7 for the rest of the update's
  float32 arithmetic.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.parallel.sharding import Policy  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_batch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.parallel.sharding import Policy as TPolicy  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as steps_lib  # noqa: E402

torch.set_num_threads(2)

CFG = ArchConfig("tiny", "dense", 2, 64, 4, 2, 128, 256)  # tests/test_train.py CFG
JCFG = JArchConfig(**dataclasses.asdict(CFG))
OCFG = dict(lr=1e-2, warmup_steps=5, total_steps=100)


def _jax_params(cfg=JCFG):
    return jget_model(cfg).init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)


def _tbatch(seq=16, batch=4, step=0, cfg=CFG):
    return {k: torch.from_numpy(v) for k, v in make_batch(cfg, seq, batch, step=step).items()}


def _jbatch(seq=16, batch=4, step=0, cfg=JCFG):
    return {k: jnp.asarray(v) for k, v in jpipe.make_batch(cfg, seq, batch, step=step).items()}


def _close(got, want, rtol=1e-4, atol_rel=None):
    """Within rtol, and an atol of ``atol_rel`` (default ``rtol``) of ``want``'s largest."""
    want = np.asarray(want, np.float32)
    atol = (atol_rel or rtol) * max(1e-30, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach().float()), want, rtol=rtol, atol=atol)


def _setup():
    params = TT.init_params(CFG, torch.Generator().manual_seed(0), dtype=torch.float32)
    step = steps_lib.make_train_step(CFG, opt.AdamWConfig(**OCFG),
                                     steps_lib.TrainOptions(remat=False))
    return params, opt.init(params), step


# ---------------------------------------------------------------------------
# one train step against JAX's make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat,use_kernel,ce_chunk,seq", [
    (False, False, 0, 16),
    (True, False, 0, 16),
    (True, True, 0, 16),
    (False, True, 0, 16),
    (True, False, 8, 16),
    (False, False, 8, 12),   # the last chunk is short (JAX pads and masks it)
    (True, True, 5, 16),
])
def test_train_step_matches_jax(remat, use_kernel, ce_chunk, seq):
    _check_train_step(CFG, remat, use_kernel, ce_chunk, seq)


# a tied unembedding, a vocab padded from 250 to 256 whose tail is masked, both
# (tests/test_torch_transformer.py's EXTRA); and a tiny MoE whose capacity
# factor of 1.25 drops tokens (16 a group, 2 choices, cap 10 an expert)
EXTRA_CFGS = [
    ArchConfig("tied", "dense", 2, 64, 4, 2, 128, 250, head_dim=16, tie_embeddings=True),
    ArchConfig("padded", "dense", 2, 64, 4, 2, 128, 250, head_dim=16, vocab_pad_to=128),
    ArchConfig("tied-padded", "dense", 2, 64, 4, 2, 128, 250, head_dim=16,
               tie_embeddings=True, vocab_pad_to=128),
]
MOE_CFG = ArchConfig("tiny-moe", "moe", 2, 64, 4, 2, 96, 256, n_experts=4, top_k=2)


@pytest.mark.parametrize("ce_chunk", [0, 5, 8])
@pytest.mark.parametrize("cfg", EXTRA_CFGS, ids=lambda c: c.name)
def test_train_step_matches_jax_tied_and_padded(cfg, ce_chunk):
    _check_train_step(cfg, True, False, ce_chunk, 16)


@pytest.mark.parametrize("remat,use_kernel,ce_chunk,moe_mode", [
    (False, False, 0, "tp"),
    (True, True, 8, "tp"),
    (True, False, 0, "gshard"),
])
def test_train_step_matches_jax_moe(remat, use_kernel, ce_chunk, moe_mode):
    """One step of the MoE family: the loss, the aux loss, every gradient leaf
    (the fp32 router and the expert stacks included) and the updated params."""
    cfg = dataclasses.replace(MOE_CFG, moe_mode=moe_mode)
    _check_train_step(cfg, remat, use_kernel, ce_chunk, 16)


@pytest.mark.parametrize("remat,use_kernel,ce_chunk", [
    (False, False, 0),
    (True, False, 0),
    (True, True, 8),  # both options are read by neither family, as in JAX
])
@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "recurrentgemma-9b-smoke"])
def test_train_step_matches_jax_ssm_and_hybrid(arch, remat, use_kernel, ce_chunk):
    """One step of the SSM and hybrid families (16 tokens: two SSD chunks of 8; the
    hybrid's window of 16): the loss, every gradient leaf (the fp32 A_log, D,
    dt_bias and lambda_p included) and the updated params.

    The hybrid's init (weights at scale 1/sqrt(L) for stacks of L = 1 or 2)
    makes near-one-hot attention that amplifies fp32 rounding: each package's
    gradients are 1e-5 to 9e-5 (relative L2 a leaf) from the port's in fp64,
    and the two differ by up to 2e-4 in elements near a leaf's largest, inside
    the gradients' tolerance (rtol 1e-4 plus 1e-4 of the leaf's largest).  The
    second moment v = (1 - b2)·g² doubles that relative difference, so v is
    held at rtol 2e-4 here."""
    _check_train_step(get_config(arch), remat, use_kernel, ce_chunk, 16, v_rtol=2e-4)


LEAF_ATOL_CAP = 1e-2  # a leaf's gradient atol, of its largest, at most
X64_ATOL = 1e-3  # the port's float64 gradients against JAX's, of a leaf's largest


@pytest.mark.parametrize("remat,use_kernel,ce_chunk", [
    (False, False, 0),
    (True, True, 0),
    (True, False, 8),  # the chunked CE for the vlm family; audio takes the full logits
])
@pytest.mark.parametrize("arch", ["qwen2-vl-7b-smoke", "whisper-tiny-smoke"])
def test_train_step_matches_jax_vlm_and_audio(arch, remat, use_kernel, ce_chunk):
    """One step of the VLM family (the batch's (3, B, S) M-RoPE positions) and of
    the audio family (the batch's encoder frames; every leaf of the encoder
    subtree, the learned positions and the cross-attention stacks): the loss,
    every gradient leaf and the updated params.

    At these smoke configs the init's near-one-hot attention leaves both
    packages' fp32 gradients far from exact.  The reference is the JAX
    package's own loss on the same weights cast to float64, under x64: JAX's
    float32 gradients are up to 2.1e-4 (vlm) and 4.3e-3 (audio) of a leaf's
    largest from it, and the two packages' float32 gradients differ by up to
    2.1e-4 and 5.2e-4.  (The vlm smoke config run as a dense RoPE model gives
    the same numbers: it is the dense path's fp32 error at this batch, not
    M-RoPE's.)  So each gradient leaf, and the first moment, is held within
    rtol 1e-4 and an atol of twice JAX's own float32 distance from that
    reference, at least 1e-4 and at most ``LEAF_ATOL_CAP``, of the leaf's
    largest, and the second moment (g²) within twice that: a bound the port
    has no part in.  The port's own gradients on the float64 weights are held
    to the JAX reference within ``X64_ATOL`` of a leaf's largest.  Not closer:
    both packages keep their norms, rotations, scores and softmax in float32
    on float64 weights, in sums of different order, and the near-one-hot
    attention amplifies that to 1.7e-5 (vlm) and 3.6e-4 (audio)."""
    cfg = get_config(arch)
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    jopts = jsteps.TrainOptions(remat=remat, use_kernel=use_kernel, ce_chunk=ce_chunk)
    jloss_fn = jsteps.make_loss_fn(jcfg, jopts)
    jparams = jax.device_get(_jax_params(jcfg))
    jbatch = jpipe.make_batch(jcfg, 16, 4)
    _, jgrads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in jbatch.items()})
    with jax.enable_x64(True):
        wide = lambda a: jnp.asarray(  # noqa: E731
            a if np.issubdtype(a.dtype, np.integer) else np.asarray(a, np.float64))
        _, jg64 = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
            jax.tree.map(wide, jparams), {k: wide(v) for k, v in jbatch.items()})
        jg64 = [np.asarray(g) for g in jax.tree.leaves(jg64)]
    assert all(g.dtype == np.float64 for g in jg64)

    f = steps_lib.value_and_grad(steps_lib.make_loss_fn(cfg, steps_lib.TrainOptions(
        remat=remat, use_kernel=use_kernel, ce_chunk=ce_chunk)))
    tparams = bridge.params_from_numpy(jparams)
    batch64 = {k: v.double() if v.is_floating_point() else v
               for k, v in _tbatch(16, cfg=cfg).items()}
    _, g64 = f(tree_lib.tree_map(lambda t: t.double(), tparams), batch64)
    leaf_atol = []
    for j, ref, t in zip(jax.tree.leaves(jgrads), jg64, tree_lib.leaves(g64)):
        scale = float(np.abs(ref).max())
        assert t.dtype == torch.float64 and scale > 0
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=X64_ATOL * scale)
        dist = float(np.abs(np.asarray(j, np.float64) - ref).max()) / scale
        leaf_atol.append(min(LEAF_ATOL_CAP, max(1e-4, 2 * dist)))
    _check_train_step(cfg, remat, use_kernel, ce_chunk, 16, leaf_atol=leaf_atol)


def _check_train_step(cfg, remat, use_kernel, ce_chunk, seq, v_rtol=1e-4, leaf_atol=None):
    """``leaf_atol``: each gradient leaf's atol (relative to its largest) where
    the default of ``_close`` does not hold it; the first moment takes the
    same and the second twice it."""
    jcfg = JArchConfig(**dataclasses.asdict(cfg))
    jopts = jsteps.TrainOptions(remat=remat, use_kernel=use_kernel, ce_chunk=ce_chunk)
    topts = steps_lib.TrainOptions(remat=remat, use_kernel=use_kernel, ce_chunk=ce_chunk)
    jparams = _jax_params(jcfg)
    jstate = jopt.init(jparams)
    tparams = bridge.params_from_numpy(jax.device_get(jparams))
    tstate = opt.init(tparams)

    # the gradients themselves
    (_, (jloss, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg, jopts), has_aux=True))(jparams, _jbatch(seq, cfg=jcfg))
    (_, (tloss, aux)), tgrads = steps_lib.value_and_grad(
        steps_lib.make_loss_fn(cfg, topts))(tparams, _tbatch(seq, cfg=cfg))
    _close(tloss, jloss)
    if cfg.family == "moe":
        _close(aux, jaux)
        assert float(aux) > 0.0
    else:
        assert float(aux) == 0.0
    jflat, tflat = jax.tree.leaves(jgrads), tree_lib.leaves(tgrads)
    assert len(jflat) == len(tflat)
    leaf_atol = leaf_atol or [None] * len(jflat)
    for t, j, atol in zip(tflat, jflat, leaf_atol):
        assert t.dtype == torch.float32
        _close(t, j, atol_rel=atol)

    # one whole step
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**OCFG), jopts, Policy()))
    jnew, jstate, jm = jstep(jparams, jstate, _jbatch(seq, cfg=jcfg))
    tstep = steps_lib.make_train_step(cfg, opt.AdamWConfig(**OCFG), topts)
    before = tfa.launches
    tnew, tstate, tm = tstep(tparams, tstate, _tbatch(seq, cfg=cfg))
    assert tfa.launches == before  # CPU tensors take the plain version
    assert tnew is tparams  # updated in place
    _close(tm["loss"], jm["loss"])
    _close(tm["aux"], jm["aux"])
    _close(tm["grad_norm"], jm["grad_norm"])
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 1 and tstate.step.dtype == torch.int32
    for name, rtol, scale in (("m", 1e-4, 1), ("v", v_rtol, 2)):
        for t, j, atol in zip(tree_lib.leaves(getattr(tstate, name)),
                              jax.tree.leaves(getattr(jstate, name)), leaf_atol):
            _close(t, j, rtol, atol_rel=atol and scale * atol)
    _assert_first_update_close(tnew, jnew, tstate, jstate, float(jm["lr"]),
                               jopt.AdamWConfig(**OCFG))


def _assert_first_update_close(tnew, jnew, tstate, jstate, lr, ocfg):
    """The first AdamW update of each element within lr·|u(g_t) − u(g_j)| (module
    docstring), after one step m = (1 − b1)·g for the clipped gradient g each
    package used."""
    eps = ocfg.eps
    for t, j, mt, mj in zip(tree_lib.leaves(tnew), jax.tree.leaves(jnew),
                            tree_lib.leaves(tstate.m), jax.tree.leaves(jstate.m)):
        t, j = t.numpy(), np.asarray(j)
        gt, gj = mt.double().numpy() / (1 - ocfg.b1), np.asarray(mj, np.float64) / (1 - ocfg.b1)
        du = np.where(np.sign(gt) == np.sign(gj),
                      eps * np.abs(gt - gj) / ((np.abs(gt) + eps) * (np.abs(gj) + eps)), 2.0)
        bound = lr * du + 1e-6 * np.abs(j) + 1e-7
        assert np.all(np.abs(t - j) <= bound), float(np.max(np.abs(t - j) - bound))


def test_loss_fn_defaults_match_jax():
    # TrainOptions' fields and defaults are the JAX package's
    assert dataclasses.asdict(steps_lib.TrainOptions()) == dataclasses.asdict(
        jsteps.TrainOptions())
    assert dataclasses.asdict(opt.AdamWConfig()) == dataclasses.asdict(jopt.AdamWConfig())


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 37), dtype=np.float32) * 3
    labels = rng.integers(0, 37, (2, 5), dtype=np.int32)
    want = jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = steps_lib.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the paper's gradient-sync modes over 16 LocalMesh ranks against JAX's auto step
# (check_collective_train_step of tests/multidevice_checks.py)
# ---------------------------------------------------------------------------

SYNC_CFG = ArchConfig("tiny", "dense", 2, 32, 4, 2, 64, 128)
SYNC_OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("sync,data_axes", [
    ("ring", ("data",)), ("bidir", ("data",)),
    ("torus", ("data", "model")), ("hamiltonian", ("data", "model")),
])
def test_sync_train_step_matches_auto_and_jax(sync, data_axes):
    """A sync step over 16 ranks updates the params as ``sync="auto"`` does on the
    whole batch: the port's own auto step at rtol 2e-4, atol 2e-5 (the JAX
    check's tolerance, where only the order of the gradient sums differs), and
    the JAX auto step under the first-update bound of the module docstring
    (the two packages' gradients differ in their last digits, which AdamW's
    first step amplifies where |g| is near eps)."""
    jcfg = JArchConfig(**dataclasses.asdict(SYNC_CFG))
    jparams = _jax_params(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in jpipe.make_batch(jcfg, 8, 16).items()}
    ocfg = opt.AdamWConfig(**SYNC_OCFG)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt.AdamWConfig(**SYNC_OCFG),
                                           jsteps.TrainOptions(remat=False), Policy()))
    jnew, jstate, jm = jstep(jparams, jopt.init(jparams), jbatch)
    batch = _tbatch(8, 16, cfg=SYNC_CFG)

    auto_params = bridge.params_from_numpy(jax.device_get(jparams))
    auto_step = steps_lib.make_train_step(SYNC_CFG, ocfg, steps_lib.TrainOptions(remat=False))
    auto_new, _, auto_m = auto_step(auto_params, opt.init(auto_params), batch)

    mesh = make_test_mesh((4, 4), ("data", "model"), "cpu")
    tparams = bridge.params_from_numpy(jax.device_get(jparams))
    step = steps_lib.make_train_step(
        SYNC_CFG, ocfg, steps_lib.TrainOptions(remat=False, sync=sync),
        TPolicy(data_axes=data_axes), mesh)
    tnew, tstate, tm = step(tparams, opt.init(tparams), batch)
    assert tnew is tparams  # updated in place, once
    np.testing.assert_allclose(float(tm["loss"]), float(auto_m["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    # the gradient's scale (the norm before clipping; m and the first update are
    # blind to it) and the clipped gradient itself, m = (1 - b1)·g
    _close(tm["grad_norm"], jm["grad_norm"])
    _close(tm["grad_norm"], auto_m["grad_norm"].numpy())
    for mt, mj in zip(tree_lib.leaves(tstate.m), jax.tree.leaves(jstate.m)):
        _close(mt, mj)
    for t, a in zip(tree_lib.leaves(tnew), tree_lib.leaves(auto_new)):
        np.testing.assert_allclose(t.numpy(), a.numpy(), rtol=2e-4, atol=2e-5)
    _assert_first_update_close(tnew, jnew, tstate, jstate, float(jm["lr"]), ocfg)
    # the gradients moved by neighbour ppermutes only; psum carried loss and aux
    assert mesh.stats.bytes and not mesh.stats.all_gather_calls
    assert mesh.stats.psum_calls == 2 * 16


@pytest.mark.parametrize("sync,compress_k", [("ring", 0), ("hamiltonian", 0), ("bidir", 8)])
def test_sync_modes_need_a_mesh(sync, compress_k):
    with pytest.raises(ValueError, match="needs a mesh"):
        steps_lib.make_train_step(CFG, opt.AdamWConfig(), steps_lib.TrainOptions(
            sync=sync, compress_k=compress_k), TPolicy())


def test_global_norm_and_apply_match_jax_with_bf16_leaf():
    # two AdamW steps on a mixed-dtype tree; moments stay float32
    rng = np.random.default_rng(3)
    p = {"a": rng.standard_normal((3, 4), dtype=np.float32),
         "b": {"c": rng.standard_normal((5,), dtype=np.float32)}}
    gs = [{"a": rng.standard_normal((3, 4), dtype=np.float32) * 2,
           "b": {"c": rng.standard_normal((5,), dtype=np.float32)}} for _ in range(2)]
    cfg_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
    jp = jax.tree.map(jnp.asarray, p)
    jp["b"]["c"] = jp["b"]["c"].astype(jnp.bfloat16)
    js = jopt.init(jp)
    tp = bridge.params_from_numpy(jax.device_get(jp))
    ts = opt.init(tp)
    assert ts.m["b"]["c"].dtype == torch.float32 and tp["b"]["c"].dtype == torch.bfloat16
    for g in gs:
        _close(opt.global_norm(bridge.params_from_numpy(g)),
               jopt.global_norm(jax.tree.map(jnp.asarray, g)), rtol=1e-6)
        jp, js, jm = jopt.apply(jopt.AdamWConfig(**cfg_kw), js, jp, jax.tree.map(jnp.asarray, g))
        tp, ts, tm = opt.apply(opt.AdamWConfig(**cfg_kw), ts, tp, bridge.params_from_numpy(g))
        _close(tm["grad_norm"], jm["grad_norm"], rtol=1e-6)
    # bf16 leaves round once a step; the float32 ones agree to a few ulp
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].float().numpy(),
                               np.asarray(jp["b"]["c"], np.float32), rtol=1e-2, atol=1e-2)
    for name in ("m", "v"):
        for t, j in zip(tree_lib.leaves(getattr(ts, name)), jax.tree.leaves(getattr(js, name))):
            _close(t, j, rtol=1e-5)


# ---------------------------------------------------------------------------
# ports of tests/test_train.py
# ---------------------------------------------------------------------------


def test_loss_descends():
    params, ostate, step = _setup()
    losses = []
    for s in range(20):
        params, ostate, metrics = step(params, ostate, _tbatch(step=s))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_data_pipeline_deterministic():
    gen = SyntheticLM(DataConfig(vocab=256, seq_len=16, global_batch=4, seed=3))
    a = gen.batch(7)
    b = gen.batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = gen.batch(8)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # labels are next-token shifted
    full = SyntheticLM(DataConfig(256, 16, 4, 3))
    d = full.batch(0)
    np.testing.assert_array_equal(d["tokens"][:, 1:], d["labels"][:, :-1])


def test_schedules():
    cos = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, schedule="cosine")
    wsd = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, schedule="wsd")
    i32 = lambda n: torch.tensor(n, dtype=torch.int32)  # noqa: E731
    assert float(opt.schedule_lr(cos, i32(0))) == 0.0
    assert float(opt.schedule_lr(cos, i32(10))) == 1.0
    assert float(opt.schedule_lr(cos, i32(110))) < 0.01
    assert float(opt.schedule_lr(wsd, i32(60))) == 1.0  # stable plateau
    assert float(opt.schedule_lr(wsd, i32(110))) < 0.2  # decayed


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedule_values_match_jax(schedule):
    kw = dict(lr=3e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    for s in (0, 1, 6, 7, 8, 20, 41, 45, 50, 60):
        want = float(jopt.schedule_lr(jopt.AdamWConfig(**kw), jnp.int32(s)))
        got = opt.schedule_lr(opt.AdamWConfig(**kw), torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)


def test_grad_clip():
    g = {"w": torch.ones((4,)) * 100.0}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == 200.0
    np.testing.assert_allclose(float(torch.linalg.vector_norm(clipped["w"])), 1.0, rtol=1e-5)
