"""Model zoo dispatch: family -> module with init_params/forward/init_cache/decode_step."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig


def get_model(cfg: ArchConfig):
    """The model module of ``cfg``'s family, as ``repro.models.get_model`` picks it.

    Every family is ported: the SSM (``mamba2``) and hybrid
    (``recurrentgemma``) families have modules of their own; the dense, MoE,
    VLM and audio families share ``transformer``.
    """
    from repro_torch.models import mamba2, recurrentgemma, transformer

    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return recurrentgemma
    return transformer
