"""Differentiable wrappers around the kernels (counterpart of ``repro.kernels.ops``).

``flash_attention`` is a ``torch.autograd.Function``: the forward runs a
CUDA kernel on CUDA tensors (``flash_attention.variant`` picks which) and the
plain version on CPU tensors; the backward
recomputes through ``ref.flash_attention_ref``, as the JAX package's
``custom_vjp`` does, under the ``attn.bwd`` span (``repro_torch.trace``).
"""

from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return fa.flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        with trace.span("attn", "bwd"):
            q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
            with torch.enable_grad():
                out = ref.flash_attention_ref(q, k, v, ctx.causal, ctx.window)
                dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
            return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0) -> torch.Tensor:
    return FlashAttention.apply(q, k, v, causal, window)
