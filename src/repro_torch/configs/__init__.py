"""Config registry: ``--arch <id>`` lookup (copy of ``repro.configs``).

The dry-run helpers of the JAX package (``input_specs``, ``abstract_params``,
``abstract_cache``) are not ported yet.
"""

from __future__ import annotations

import importlib

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
