"""AdamW, learning-rate schedules and clipping (counterpart of ``repro.train.optimizer``).

The arithmetic follows the JAX version step for step, so float32 results
agree: the moments are float32 whatever the parameter dtype, the bias
corrections are ``1 - b**step`` in float32, and
``delta = m̂/(√v̂ + eps) + wd·p``.  ``step`` is a 0-d int32 tensor, as in
JAX; the checkpoint format stores it so.

Unlike the JAX version, ``apply`` updates parameters and moments in place,
leaf by leaf: done out of place at the full width of llama3.2-3b it would
hold two copies of 43 GB of parameters and moments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch import tree as tree_lib


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd | constant
    wsd_stable_frac: float = 0.8  # fraction of post-warmup steps held stable


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor), as a 0-d float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    rest = torch.clamp(step - cfg.warmup_steps, min=0.0)
    horizon = max(1.0, cfg.total_steps - cfg.warmup_steps)
    frac = torch.clamp(rest / horizon, 0.0, 1.0)
    if cfg.schedule == "cosine":
        return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))
    # WSD: stable plateau then linear decay to 10% (MiniCPM)
    stable = cfg.wsd_stable_frac
    decay_frac = torch.clamp((frac - stable) / max(1e-6, 1.0 - stable), 0.0, 1.0)
    return cfg.lr * warm * (1.0 - 0.9 * decay_frac)


def init(params) -> AdamWState:
    """Zero float32 moments beside each parameter, on its device; step 0."""
    device = tree_lib.leaves(params)[0].device
    zeros = tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
                      v=tree_lib.tree_map(torch.clone, zeros))


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_lib.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm_fn=global_norm):
    """(grads scaled to a global norm of at most ``max_norm``, the norm before).

    The gradients are scaled in place; the tree returned is the one passed in.
    ``norm_fn(grads)`` gives the norm: ``global_norm`` of the tree, or, where
    ``grads`` are a rank's blocks, the whole gradient's
    (``TensorParallel.global_norm``).
    """
    norm = norm_fn(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_lib.leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def apply(cfg: AdamWConfig, state: AdamWState, params, grads, norm_fn=global_norm):
    """One AdamW step -> (params, state, metrics), in place.

    ``params``, the moments in ``state`` and ``grads`` (clipped) are updated in
    place, one leaf at a time, and the returned params and state are the ones
    passed in (``state.step`` is a new tensor).  So a step needs no second copy
    of the parameters or moments, only a few leaf-sized temporaries.
    ``norm_fn`` is ``clip_by_global_norm``'s.
    """
    with trace.span("opt"):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm_fn)
        step = state.step + 1
        lr = schedule_lr(cfg, step)
        fstep = step.float()
        b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=fstep.device), fstep)
        b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=fstep.device), fstep)

        flat_p = tree_lib.leaves(params)
        flat_g = tree_lib.leaves(grads)
        flat_m = tree_lib.leaves(state.m)
        flat_v = tree_lib.leaves(state.v)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v, strict=True):
            g32 = g.float()
            m.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
            denom = (v / b2c).sqrt_().add_(cfg.eps)
            delta = (m / b1c).div_(denom)
            del denom
            p32 = p.float()
            delta.add_(p32 * cfg.weight_decay)
            p.copy_(p32 - delta.mul_(lr))
        return params, AdamWState(step, state.m, state.v), {"lr": lr, "grad_norm": gnorm}
