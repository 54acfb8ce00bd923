"""Weights drawn from the seed on the device, laid out as the program takes them.

Every matrix is drawn from N(0, 1/fan_in), fan_in its input width, so the
scale of a layer does not depend on how many layers a configuration keeps;
the embedding from N(0, 1) and the norms' gammas at zero (the norm multiplies
by 1 + gamma). All matrices of one dtype are slices of one buffer filled by a
few large draws, the router in float32 whatever the serving dtype.
"""

from __future__ import annotations

import math

import torch

from portbench.feed import row_seed

CHUNK = 1 << 30  # elements a draw fills


def leaves(cfg: dict, dtype) -> list[tuple[str, tuple, float, torch.dtype]]:
    """(dotted path, shape, std, dtype) of every random leaf, in draw order."""
    d, hd, h, kv = cfg["d_model"], cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    n, f, v = cfg["n_layers"], cfg["d_ff"], cfg["vocab"]
    out = [("embed", (v, d), 1.0, dtype),
           ("layers.wq", (n, d, h * hd), d ** -0.5, dtype),
           ("layers.wk", (n, d, kv * hd), d ** -0.5, dtype),
           ("layers.wv", (n, d, kv * hd), d ** -0.5, dtype),
           ("layers.wo", (n, h * hd, d), (h * hd) ** -0.5, dtype)]
    if cfg.get("n_experts"):
        e = cfg["n_experts"]
        out += [("layers.moe.router", (n, d, e), d ** -0.5, torch.float32),
                ("layers.moe.w_gate", (n, e, d, f), d ** -0.5, dtype),
                ("layers.moe.w_up", (n, e, d, f), d ** -0.5, dtype),
                ("layers.moe.w_down", (n, e, f, d), f ** -0.5, dtype)]
    else:
        out += [("layers.w_gate", (n, d, f), d ** -0.5, dtype),
                ("layers.w_up", (n, d, f), d ** -0.5, dtype),
                ("layers.w_down", (n, f, d), f ** -0.5, dtype)]
    return out + [("unembed", (d, v), d ** -0.5, dtype)]


def _put(tree: dict, path: str, value) -> None:
    *inner, last = path.split(".")
    for key in inner:
        tree = tree.setdefault(key, {})
    tree[last] = value


def make(cfg: dict, seed: int, dtype, device) -> dict:
    """The weights of ``cfg`` for ``seed``: the same tensors for the same seed."""
    device = torch.device(device)
    spec = leaves(cfg, dtype)
    sizes: dict[torch.dtype, int] = {}
    for _, shape, _, dt in spec:
        sizes[dt] = sizes.get(dt, 0) + math.prod(shape)
    gen = torch.Generator(device).manual_seed(row_seed(seed, "weights"))
    flat = {}
    for dt, size in sizes.items():
        flat[dt] = torch.empty(size, dtype=dt, device=device)
        for start in range(0, size, CHUNK):
            flat[dt][start:start + CHUNK].normal_(generator=gen)
    tree: dict = {}
    offset = dict.fromkeys(sizes, 0)
    for path, shape, std, dt in spec:
        size = math.prod(shape)
        _put(tree, path, flat[dt][offset[dt]:offset[dt] + size].view(shape).mul_(std))
        offset[dt] += size
    n, d = cfg["n_layers"], cfg["d_model"]
    for norm in ("attn_norm", "mlp_norm"):
        tree["layers"][norm] = {"scale": torch.zeros((n, d), device=device)}
    tree["final_norm"] = {"scale": torch.zeros((d,), device=device)}
    return tree


def named_slices(tree: dict, prefix: str = ""):
    """(name, tensor) of every leaf; a stacked layer leaf gives one slice a layer."""
    for key in sorted(tree):
        node, name = tree[key], f"{prefix}{key}"
        if isinstance(node, dict):
            yield from named_slices(node, name + ".")
        elif name.startswith("layers."):
            for i, part in enumerate(node):
                yield f"{name}[{i}]", part
        else:
            yield name, node
