"""Serving steps (the serving part of ``repro.train.steps``).

Loss, optimizer, gradient sync and the train step come with the training
slice (ROADMAP Queue A).  The steps run without autograd.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import get_model


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    remat: bool = True  # accepted for the JAX signature; no effect when serving
    use_kernel: bool = False


def make_prefill_step(cfg: ArchConfig, options: TrainOptions):
    """prefill_step(params, batch) -> logits of the last position, (B, 1, V)."""
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        extras = {}
        if "positions" in batch:
            extras["positions"] = batch["positions"]
        logits, _ = model.forward(
            cfg, params, batch["tokens"], remat=options.remat,
            use_kernel=options.use_kernel, **extras,
        )
        return logits[:, -1:]

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """serve_step(params, cache, tokens (B, 1)) -> (next tokens (B, 1) int32, cache)."""
    model = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(cfg, params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step
