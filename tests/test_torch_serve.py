"""The port's serving entry points: data, CLI, weight bridge and device choice."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.comm import LocalMesh  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, mamba2, recurrentgemma, transformer  # noqa: E402
from repro_torch.testing import bridge  # noqa: E402
from repro_torch.train import steps as steps_lib  # noqa: E402

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,seq,batch,step,seed", [
    ("llama3.2-3b-smoke", 32, 4, 0, 0),
    ("llama3.2-3b", 64, 2, 3, 7),      # full vocab: Zipf over the first 4096 ids
    ("qwen2-vl-7b-smoke", 16, 2, 1, 0),  # with M-RoPE positions
])
def test_make_batch_bit_identical(arch, seq, batch, step, seed):
    want = jpipe.make_batch(jget_config(arch), seq, batch, step=step, seed=seed)
    got = tpipe.make_batch(get_config(arch), seq, batch, step=step, seed=seed)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_make_batch_audio_waits_for_its_slice():
    """The name is historical (the batch refused the audio family before its
    slice was ported): the batch now carries JAX's encoder frames, as float32
    arrays of its bfloat16 values (bit for bit in test_torch_audio.py)."""
    want = jpipe.make_batch(jget_config("whisper-tiny-smoke"), 8, 2)
    got = tpipe.make_batch(get_config("whisper-tiny-smoke"), 8, 2)
    assert sorted(got) == sorted(want)
    assert got["encoder_frames"].dtype == np.float32
    np.testing.assert_array_equal(got["encoder_frames"],
                                  np.asarray(want["encoder_frames"]).astype(np.float32))


def test_serve_cli_runs_on_cpu():
    _check_serve_cli("llama3.2-3b-smoke")


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b-smoke", "dbrx-132b-smoke"])
def test_serve_cli_runs_the_moe_family_on_cpu(arch):
    _check_serve_cli(arch)


@pytest.mark.parametrize("arch", ["mamba2-130m-smoke", "recurrentgemma-9b-smoke"])
def test_serve_cli_runs_the_ssm_and_hybrid_families_on_cpu(arch):
    _check_serve_cli(arch)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b-smoke", "whisper-tiny-smoke"])
def test_serve_cli_runs_the_vlm_and_audio_families_on_cpu(arch):
    _check_serve_cli(arch)


def _check_serve_cli(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--decode", "4"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 2
    assert f"arch={arch} batch=2 prefill 8 toks" in lines[0]
    assert "decoded 4 toks/seq" in lines[0]
    ids = eval(lines[1].split(":", 1)[1])  # the 4 decoded ids of sequence 0
    assert len(ids) == 4 and all(0 <= i < get_config(arch).vocab for i in ids)


def test_serve_decodes_like_the_decode_step():
    cfg = get_config("llama3.2-3b-smoke")
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    prompts = torch.from_numpy(tpipe.make_batch(cfg, 6, 2)["tokens"])
    res = serve.serve(cfg, params, prompts, 3)
    assert res["tokens"].shape == (2, 3) and res["tokens"].dtype == torch.int32
    cache = model.init_cache(cfg, 2, 9, dtype=torch.float32)
    for t in range(6):
        logits, cache = model.decode_step(cfg, params, cache, prompts[:, t:t + 1])
    want = []
    for _ in range(3):
        tok = torch.argmax(logits[:, -1], -1, keepdim=True)
        logits, cache = model.decode_step(cfg, params, cache, tok)
        want.append(torch.argmax(logits[:, -1], -1))
    np.testing.assert_array_equal(res["tokens"].numpy(), torch.stack(want, 1).numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trips_exactly(dtype):
    cfg = jget_config("llama3.2-3b-smoke")
    tree = jax.device_get(JT.init_params(cfg, jax.random.PRNGKey(3), dtype=dtype))
    tparams = bridge.params_from_numpy(tree)
    assert tparams["layers"]["wq"].dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                                             else torch.float32)
    back = bridge.params_to_numpy(tparams)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_entry_points_want_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so cuda resolves")
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    for arch in ("llama3.2-3b-smoke", "mamba2-130m-smoke", "recurrentgemma-9b-smoke"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", arch, "--decode", "1"])


@pytest.mark.parametrize("arch", ["dbrx-132b-smoke", "mamba2-130m-smoke",
                                  "recurrentgemma-9b-smoke", "qwen2-vl-7b-smoke",
                                  "whisper-tiny-smoke"])
def test_unported_families_raise(arch, monkeypatch):
    """Each family the port lacks raises naming its ROADMAP item; of the moe family,
    which is ported, the expert-parallel forward (``moe_mode="ep"``) raises without
    the rank's ``Comm`` in ``act_specs`` and runs inside ``Mesh.run`` with it.  The
    ssm and hybrid families are ported now: ``get_model`` gives their modules,
    and their ``forward`` ignores ``use_kernel`` as JAX's ``**_`` does, so the
    flash op, made to raise here, is never called.  The vlm and audio families
    are ported too: ``get_model`` gives the transformer, and with ``use_kernel``
    the flash op runs once a decoder layer (the decoder's self-attention; the
    encoder and the cross-attention stay plain, as in JAX)."""
    cfg = get_config(arch)
    if cfg.family in ("vlm", "audio"):
        model = get_model(cfg)
        assert model is transformer
        calls = []

        def counted(*args, **kwargs):
            calls.append(kwargs)
            return tfa.plain(*args, causal=kwargs["causal"], window=kwargs["window"])

        monkeypatch.setattr(kops, "flash_attention", counted)
        params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
        batch = {k: torch.from_numpy(v) for k, v in tpipe.make_batch(cfg, 24, 2).items()}
        extras = steps_lib.model_extras(batch)
        logits, _ = model.forward(cfg, params, batch["tokens"], use_kernel=True, **extras)
        assert logits.shape == (2, 24, cfg.vocab) and torch.isfinite(logits).all()
        assert calls == [{"causal": True, "window": 0}] * cfg.n_layers
        return
    if cfg.family in ("ssm", "hybrid"):
        model = get_model(cfg)
        assert model is {"ssm": mamba2, "hybrid": recurrentgemma}[cfg.family]

        def no_flash(*args, **kwargs):
            raise AssertionError("the flash op was called")

        monkeypatch.setattr(kops, "flash_attention", no_flash)
        params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
        toks = torch.from_numpy(tpipe.make_batch(cfg, 24, 2)["tokens"])  # past the window
        logits, _ = model.forward(cfg, params, toks, use_kernel=True)
        assert logits.shape == (2, 24, cfg.vocab) and torch.isfinite(logits).all()
        return
    if cfg.family != "moe":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_model(cfg)
        return
    cfg = dataclasses.replace(cfg, moe_mode="ep")
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="act_specs"):
        model.forward(cfg, params, toks)
    mesh = LocalMesh((2,), ("model",), "cpu", timeout=60.0)
    for logits, _ in mesh.run(lambda c: model.forward(cfg, params, toks,
                                                      act_specs={"mesh": c})):
        assert logits.shape == (1, 4, cfg.vocab) and torch.isfinite(logits).all()
