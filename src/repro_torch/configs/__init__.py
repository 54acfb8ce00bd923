"""Config registry: ``--arch <id>`` lookup + input_specs for the dry-run
(copy of ``repro.configs``).

``input_specs``, ``abstract_params`` and ``abstract_cache`` return tensors on
the ``meta`` device, the counterpart of JAX's ``ShapeDtypeStruct``: the exact
shapes and dtypes, and no storage.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "mamba2-130m": "mamba2_130m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "minicpm-2b": "minicpm_2b",
    "internlm2-20b": "internlm2_20b",
    "llama3.2-3b": "llama3_2_3b",
    "granite-8b": "granite_8b",
    "dbrx-132b": "dbrx_132b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "gpt3-paper": "gpt3_paper",
}

ASSIGNED_ARCHS = [a for a in _MODULES if a != "gpt3-paper"]


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    if name.endswith("-smoke"):
        name, smoke = name[: -len("-smoke")], True
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


def list_archs() -> list[str]:
    return list(ASSIGNED_ARCHS)


def valid_cells(arch: str) -> list[str]:
    """Shape names that apply to this arch (long_500k only sub-quadratic)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if not cfg.quadratic_attention:
        cells.append("long_500k")
    return cells


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str) -> dict:
    """Meta stand-ins for a step's batch (a decode step's: its tokens)."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((b, 1))}
    specs = {"tokens": spec((b, s))}
    if shape.kind == "train":
        specs["labels"] = spec((b, s))
    if cfg.rope_type == "mrope":
        specs["positions"] = spec((3, b, s))
    if cfg.enc_layers:
        specs["encoder_frames"] = spec((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    return specs


def _to_meta(tree):
    from repro_torch import tree as tree_lib

    return tree_lib.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    """The parameters of the model's own ``init_params``, traced on fake tensors
    (nothing is allocated), as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import get_model

    with FakeTensorMode():
        params = get_model(cfg).init_params(cfg, torch.Generator("cpu").manual_seed(0),
                                            dtype=dtype)
    return _to_meta(params)


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16):
    """The model's ``init_cache`` as meta tensors.  The port keeps ``len`` as a
    Python int; here it is an int32 scalar, as in JAX."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import get_model

    with FakeTensorMode():
        cache = get_model(cfg).init_cache(cfg, batch, max_len, dtype=dtype, device="cpu")
    cache["len"] = torch.empty((), dtype=torch.int32, device="meta")
    return _to_meta(cache)
