"""Move parameter trees between the JAX package's layout and the port's.

Both packages use the same nested-dict layout with the same key names, so the
bridge is one-to-one: a tree of NumPy arrays (``jax.device_get`` of the JAX
params) becomes a tree of tensors, and back.  The AdamW state crosses the
same way: its ``step`` and the moment trees ``m`` and ``v``.  bfloat16
crosses as a uint16 view, as ``repro/checkpoint/checkpoint.py`` stores it, so
both directions are bit-exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.train.optimizer import AdamWState


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def params_from_numpy(tree, device="cpu"):
    """Nested dict of NumPy arrays (fp32 or ml_dtypes bfloat16) -> tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree)  # a writable copy: the tensor owns its memory
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_to_numpy(tree):
    """Nested dict of tensors -> NumPy arrays; bfloat16 as ml_dtypes.bfloat16."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # NumPy's bfloat16, needed only for this direction

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def opt_state_from_numpy(state, device="cpu") -> AdamWState:
    """The JAX ``AdamWState`` (step, m, v), as NumPy (``jax.device_get``), -> the port's."""
    step, m, v = state
    return AdamWState(step=params_from_numpy(np.asarray(step, np.int32), device),
                      m=params_from_numpy(m, device), v=params_from_numpy(v, device))


def opt_state_to_numpy(state: AdamWState) -> tuple:
    """The port's AdamW state -> (step, m, v) of NumPy arrays; ``AdamWState(*t)`` in JAX."""
    return (params_to_numpy(state.step), params_to_numpy(state.m),
            params_to_numpy(state.v))
