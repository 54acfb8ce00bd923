"""The port's checkpoint, allocation copy and train driver against the JAX package's.

Checkpoints cross in both directions and must restore to exact equality
(bf16 included): the format stores the bits.  The allocation copy must make
the same placements as ``repro.core.allocation`` over a seeded sequence of
allocations, board failures and remaps.  The train driver runs on the CPU.
"""

import dataclasses
import importlib.util
import json
import os
import random
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.core import allocation as jalloc  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import allocation as talloc  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as steps_lib  # noqa: E402

torch.set_num_threads(2)

CFG = ArchConfig("tiny", "dense", 2, 64, 4, 2, 128, 256)  # tests/test_train.py CFG


def _setup():
    params = TT.init_params(CFG, torch.Generator().manual_seed(0), dtype=torch.float32)
    step = steps_lib.make_train_step(
        CFG, opt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100),
        steps_lib.TrainOptions(remat=False))
    return params, opt.init(params), step


def _batch(s):
    return {k: torch.from_numpy(v) for k, v in make_batch(CFG, 16, 4, step=s).items()}


def _clone(tree):
    return tree_lib.tree_map(torch.clone, tree)


def _mixed_state():
    """A JAX {"p": params, "o": AdamWState} with a bf16 leaf, and non-zero moments."""
    jcfg = JArchConfig(**dataclasses.asdict(CFG))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params["embed"] = params["embed"].astype(jnp.bfloat16)
    state = jopt.init(params)
    rng = np.random.default_rng(0)
    state = jopt.AdamWState(
        step=jnp.int32(7),
        m=jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), state.m),
        v=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), state.v))
    return {"p": params, "o": state}


def _port_state(jstate):
    host = jax.device_get(jstate)
    return {"p": bridge.params_from_numpy(host["p"]), "o": bridge.opt_state_from_numpy(host["o"])}


def _assert_same_bits(tstate, jstate):
    tl, jl = tree_lib.leaves(tstate), jax.tree.leaves(jstate)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if j.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                          j.view(np.uint16))
        else:
            assert str(t.dtype).split(".")[-1] == str(j.dtype)
            np.testing.assert_array_equal(t.numpy(), j)


# ---------------------------------------------------------------------------
# ports of tests/test_train.py
# ---------------------------------------------------------------------------


def test_checkpoint_restart_resumes_identically():
    params, ostate, step = _setup()
    for s in range(5):
        params, ostate, _ = step(params, ostate, _batch(s))
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_step(d, {"p": params, "o": ostate}, 5)
        # continue original (the step updates in place: continue on a copy)
        cont_p, cont_o = _clone(params), opt.AdamWState(*_clone(tuple(ostate)))
        for s in range(5, 8):
            cont_p, cont_o, _ = step(cont_p, cont_o, _batch(s))
        # restart from checkpoint (simulated failure) and replay
        restored, start = ckpt.restore_latest(d, {"p": params, "o": ostate})
        rp, ro = restored["p"], restored["o"]
        assert start == 5 and isinstance(ro, opt.AdamWState)
        for s in range(5, 8):
            rp, ro, _ = step(rp, ro, _batch(s))
        for a, b in zip(tree_lib.leaves(cont_p), tree_lib.leaves(rp)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_checkpoint_retention():
    params, _, _ = _setup()
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save_step(d, {"p": params}, s, keep=2)
        assert ckpt.latest_step(d) == 5
        steps = sorted(n for n in os.listdir(d) if n.startswith("step_"))
        assert steps == ["step_4", "step_5"]


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def test_flatten_order_is_jax_tree_flatten():
    jstate = _mixed_state()
    tstate = _port_state(jstate)
    leaves, structure = tree_lib.flatten(tstate)
    jleaves, jdef = jax.tree.flatten(jstate)
    assert tree_lib.describe(structure) == str(jdef)
    assert [tuple(t.shape) for t in leaves] == [j.shape for j in jleaves]
    assert tree_lib.unflatten(structure, leaves)["o"].step is tstate["o"].step


def test_port_restores_a_jax_checkpoint_exactly():
    jstate = _mixed_state()
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_step(d, jstate, 7)
        target = _port_state(jax.tree.map(jnp.zeros_like, jstate))
        restored, step = ckpt.restore_latest(d, target)
    assert step == 7 and restored["o"].step.dtype == torch.int32
    assert restored["p"]["embed"].dtype == torch.bfloat16
    _assert_same_bits(restored, jstate)


def test_jax_restores_a_port_checkpoint_exactly():
    jstate = _mixed_state()
    tstate = _port_state(jstate)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_step(d, tstate, 7)
        with open(os.path.join(d, "step_7", ckpt.MANIFEST)) as f:
            manifest = json.load(f)
        assert manifest["treedef"] == str(jax.tree.structure(jstate))
        assert manifest["dtypes"][:2] == ["int32", "float32"]  # o.step, then o.m's leaves
        target = jax.tree.map(jnp.zeros_like, jstate)
        restored, step = jckpt.restore_latest(d, target)
    assert step == 7 and isinstance(restored["o"], jopt.AdamWState)
    _assert_same_bits(tstate, restored)


def test_restore_rejects_a_mismatched_target():
    params, ostate, _ = _setup()
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d + "/c", {"p": params}, 1)
        with pytest.raises(ValueError, match="leaves"):
            ckpt.restore(d + "/c", {"p": params, "o": ostate})
        bad = dict(params, embed=torch.zeros(3, 3))
        with pytest.raises(ValueError, match="leaf"):
            ckpt.restore(d + "/c", {"p": bad})


MOE_CFG = ArchConfig("tiny-moe", "moe", 2, 64, 4, 2, 96, 256, n_experts=4, top_k=2)
AUDIO_CFG = ArchConfig("tiny-audio", "audio", 2, 64, 4, 4, 128, 256, head_dim=16, enc_layers=2,
                       enc_seq=16, max_pos=64, rope_type="learned", norm_type="layernorm",
                       act="gelu")


def test_moe_state_crosses_both_ways_exactly():
    """bf16 MoE params with their fp32 router (the nested layers.moe subtree) and
    AdamW's moments: through the bridge, one AdamW step, and checkpoints both ways."""
    jcfg = JArchConfig(**dataclasses.asdict(MOE_CFG))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jparams, jstate, _ = jopt.apply(jopt.AdamWConfig(**ocfg), jopt.init(params), params, grads)
    tparams = bridge.params_from_numpy(jax.device_get(params))
    moe = tparams["layers"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_gate"].dtype == torch.bfloat16
    tparams, tstate, _ = opt.apply(opt.AdamWConfig(**ocfg), opt.init(tparams), tparams,
                                   bridge.params_from_numpy(jax.device_get(grads)))
    for t, j in zip(tree_lib.leaves(tparams), jax.tree.leaves(jparams)):
        tol = 1e-6 if t.dtype == torch.float32 else 1e-2  # bf16 rounds once a step
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol,
                                   atol=tol)
    jfull = {"p": jparams, "o": jstate}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_step(d, jfull, 3)
        restored, step = ckpt.restore_latest(d, _port_state(jax.tree.map(jnp.zeros_like, jfull)))
        assert step == 3
        _assert_same_bits(restored, jfull)
        ckpt.save_step(d + "/port", restored, 4)
        back, step = jckpt.restore_latest(d + "/port", jax.tree.map(jnp.zeros_like, jfull))
    assert step == 4
    _assert_same_bits(restored, back)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_encoder_state_crosses_both_ways_exactly(dtype):
    """The audio family's params (the encoder subtree with its layers, final norm
    and pos_embed; the decoder's pos_embed and cross-attention stacks) and
    AdamW's moments: through the bridge both ways, one AdamW step, and
    checkpoints both ways."""
    jcfg = JArchConfig(**dataclasses.asdict(AUDIO_CFG))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    assert {"encoder", "pos_embed"} <= set(params) and "xwq" in params["layers"]
    host = jax.device_get(params)
    tparams = bridge.params_from_numpy(host)
    assert tparams["encoder"]["pos_embed"].shape == (AUDIO_CFG.enc_seq, AUDIO_CFG.d_model)
    _assert_same_bits(bridge.params_from_numpy(bridge.params_to_numpy(tparams)), host)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jparams, jstate, _ = jopt.apply(jopt.AdamWConfig(**ocfg), jopt.init(params), params, grads)
    tparams, tstate, _ = opt.apply(opt.AdamWConfig(**ocfg), opt.init(tparams), tparams,
                                   bridge.params_from_numpy(jax.device_get(grads)))
    for t, j in zip(tree_lib.leaves(tparams), jax.tree.leaves(jparams)):
        tol = 1e-6 if t.dtype == torch.float32 else 1e-2  # bf16 rounds once a step
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol,
                                   atol=tol)
    jfull = {"p": jparams, "o": jstate}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_step(d, jfull, 3)
        restored, step = ckpt.restore_latest(d, _port_state(jax.tree.map(jnp.zeros_like, jfull)))
        assert step == 3
        _assert_same_bits(restored, jfull)
        ckpt.save_step(d + "/port", restored, 4)
        back, step = jckpt.restore_latest(d + "/port", jax.tree.map(jnp.zeros_like, jfull))
    assert step == 4
    _assert_same_bits(restored, back)


def test_opt_state_bridge_round_trips():
    jstate = _mixed_state()["o"]
    back = jopt.AdamWState(*bridge.opt_state_to_numpy(bridge.opt_state_from_numpy(
        jax.device_get(jstate))))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the allocation copy
# ---------------------------------------------------------------------------


def _placement(pl):
    return None if pl is None else (pl.jid, list(pl.rows), list(pl.cols))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocation_copy_matches_repro(seed):
    rng = random.Random(seed)
    ja, ta = jalloc.HxMeshAllocator(8, 8), talloc.HxMeshAllocator(8, 8)
    for jid in range(40):
        op = rng.random()
        if op < 0.55:
            u, v = rng.randint(1, 4), rng.randint(1, 4)
            kw = dict(transpose=rng.random() < 0.5, aspect=rng.random() < 0.5)
            got = ta.allocate(talloc.Job(jid, u, v), **kw)
            want = ja.allocate(jalloc.Job(jid, u, v), **kw)
            assert _placement(got) == _placement(want)
            if got is not None:
                assert talloc.is_virtual_subhxmesh(got.boards)
        elif op < 0.8:
            r, c = rng.randrange(8), rng.randrange(8)
            assert ta.fail_board(r, c) == ja.fail_board(r, c)
        else:
            u, v = rng.randint(1, 3), rng.randint(1, 3)
            got = talloc.remap_after_failure(ta, talloc.Job(jid, u, v), transpose=True,
                                             aspect=True)
            want = jalloc.remap_after_failure(ja, jalloc.Job(jid, u, v), transpose=True,
                                              aspect=True)
            assert _placement(got) == _placement(want)
        assert ta.free == ja.free and ta.failed == ja.failed
        assert sorted(ta.placements) == sorted(ja.placements)
    for size in (1, 6, 12, 16):
        job = (size, 1)
        assert talloc.job_shapes(talloc.Job(0, *job), True, True) == jalloc.job_shapes(
            jalloc.Job(0, *job), True, True)
    for boards in ([(0, 1), (0, 2), (3, 1), (3, 2)], [(0, 1), (3, 2)], []):
        assert talloc.is_virtual_subhxmesh(boards) == jalloc.is_virtual_subhxmesh(boards)


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------


def test_train_cli_failure_remap_and_restore_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        out = train_cli.main([
            "--arch", "llama3.2-3b-smoke", "--steps", "12", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", d, "--checkpoint-every", "4", "--simulate-failure", "6",
            "--device", "cpu"])
        assert sorted(os.listdir(d)) == ["step_12", "step_4", "step_8"]
    text = capsys.readouterr().out
    assert "[failure] board (0,0) failed" in text
    assert "[failure] remapped to rows=" in text
    assert "[failure] restarted from checkpoint step 4" in text
    assert "[train] step   12 loss" in text and "[train] done: 12 steps" in text
    assert out["step"] == 12 and np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b-smoke", "dbrx-132b-smoke"])
def test_train_cli_moe_failure_remap_and_restore_on_cpu(arch, capsys):
    _check_failure_remap_and_restore(arch, capsys)


@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "recurrentgemma-9b-smoke"])
def test_train_cli_ssm_and_hybrid_failure_remap_and_restore_on_cpu(arch, capsys):
    _check_failure_remap_and_restore(arch, capsys)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b-smoke", "whisper-tiny-smoke"])
def test_train_cli_vlm_and_audio_failure_remap_and_restore_on_cpu(arch, capsys):
    _check_failure_remap_and_restore(arch, capsys)


def _check_failure_remap_and_restore(arch, capsys):
    """6 steps with a board failure at 3 and a restart from the checkpoint of step
    2, then a second run that resumes from step 6 to 8."""
    with tempfile.TemporaryDirectory() as d:
        args = ["--arch", arch, "--batch", "2", "--seq", "16", "--checkpoint-dir", d,
                "--checkpoint-every", "2", "--device", "cpu"]
        out = train_cli.main(args + ["--steps", "6", "--simulate-failure", "3"])
        resumed = train_cli.main(args + ["--steps", "8"])
    text = capsys.readouterr().out
    assert "[failure] restarted from checkpoint step 2" in text
    assert "[train] done: 6 steps" in text and "[train] resumed from step 6" in text
    assert out["step"] == 6 and resumed["step"] == 8
    assert np.isfinite(out["loss"]) and np.isfinite(resumed["loss"])


def test_train_cli_resumes_from_a_checkpoint(capsys):
    with tempfile.TemporaryDirectory() as d:
        args = ["--steps", "4", "--batch", "2", "--seq", "8", "--checkpoint-dir", d,
                "--checkpoint-every", "2", "--device", "cpu"]
        train_cli.main(args)
        out = train_cli.main(["--steps", "6"] + args[2:])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert out["step"] == 6


@pytest.mark.parametrize("sync", ["ring", "bidir"])
def test_train_cli_sync_on_one_rank_matches_auto(sync):
    # a one-rank "data" mesh, as the JAX driver on one device: the ring moves
    # nothing and the mean over one rank is the gradient itself
    args = ["--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu"]
    synced = train_cli.main(args + ["--sync", sync])
    auto = train_cli.main(args)
    assert synced["step"] == auto["step"] == 3
    np.testing.assert_allclose(synced["loss"], auto["loss"], rtol=1e-6)
    np.testing.assert_allclose(synced["grad_norm"], auto["grad_norm"], rtol=1e-6)


def test_train_cli_compress_k_runs_with_a_sync_mode():
    out = train_cli.main(["--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
                          "--sync", "ring", "--compress-k", "8"])
    assert out["step"] == 3 and np.isfinite(out["loss"])


@pytest.mark.parametrize("sync", ["torus", "hamiltonian"])
def test_train_cli_two_axis_sync_needs_a_2d_mesh(sync):
    with pytest.raises(ValueError, match="needs a 2D mesh"):
        train_cli.main(["--steps", "1", "--batch", "2", "--seq", "8", "--device", "cpu",
                        "--sync", sync])


def _example(name):
    path = os.path.join(os.path.dirname(__file__), "..", "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,extra", [
    ("train_lm_torch", []),
    ("fault_tolerant_training_torch", ["--simulate-failure", "2", "--checkpoint-every", "1"]),
    ("serve_decode_torch", ["--batch", "2", "--prompt-len", "4", "--decode", "3"]),
])
def test_examples_twins_run_on_cpu(name, extra, capsys):
    if name == "serve_decode_torch":  # the server: the SSM arch by default
        _example(name).main(["--device", "cpu", *extra])
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve]")]
        assert "arch=mamba2-130m-smoke batch=2 prefill 4 toks" in lines[0]
        assert "decoded 3 toks/seq" in lines[0] and len(eval(lines[1].split(":", 1)[1])) == 3
        return
    out = _example(name).main(["--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
                               *extra])
    assert out["step"] == 3 and np.isfinite(out["loss"])
    text = capsys.readouterr().out
    assert "[train] done: 3 steps" in text
    if extra:
        assert "[failure] restarted from checkpoint step 2" in text


def test_train_cli_use_kernel_takes_the_kernel_op_on_cpu():
    # --use-kernel routes attention through the flash op; on CPU tensors the
    # op computes its plain version (no launch), so the losses agree with the
    # default dense path to fp32 rounding
    from repro_torch.kernels import flash_attention as tfa

    args = ["--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu"]
    before = tfa.launches
    with_op = train_cli.main(args + ["--use-kernel"])
    without = train_cli.main(args)
    assert tfa.launches == before
    assert with_op["step"] == without["step"] == 3
    np.testing.assert_allclose(with_op["loss"], without["loss"], rtol=1e-5)
    np.testing.assert_allclose(with_op["grad_norm"], without["grad_norm"], rtol=1e-3)
