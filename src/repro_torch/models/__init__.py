"""Model zoo dispatch: family -> module with init_params/forward/init_cache/decode_step."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig


def get_model(cfg: ArchConfig):
    """The model module of ``cfg``'s family; the dense and MoE families are ported."""
    from repro_torch.models import transformer

    transformer._require_ported(cfg)
    return transformer
