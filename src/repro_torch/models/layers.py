"""Shared neural-network layers (the part of ``repro.models.layers`` the port uses).

Conventions, as in the JAX package:
* params are nested dicts of tensors; layer-stacked params carry a leading
  layer dimension;
* activations default to bfloat16, reductions and softmax run in float32;
* attention supports GQA, causal masks, sliding windows, chunked
  (online-softmax) evaluation for long sequences, and single-token decode
  against a KV cache.

Each function keeps the JAX version's order of casts (where it rounds to the
input dtype), so both packages round at the same places.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels import ops as kops

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.bfloat16) -> torch.Tensor:
    # fan_in is shape[0], as in the JAX package: for layer-stacked (L, d, .)
    # weights that is L (ROADMAP Queue C).
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def dense_init_by_layer(gen: torch.Generator, shape, dtype=torch.bfloat16) -> torch.Tensor:
    """``dense_init``'s distribution (fan_in ``shape[0]``) drawn one leading
    index at a time into a tensor of ``dtype``.

    For the layer-stacked expert weights, whose float32 draw at full width
    would be tens of GB beside the result: the peak is one layer's slab.
    """
    scale = 1.0 / math.sqrt(shape[0])
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for part in out:
        part.copy_(torch.randn(shape[1:], generator=gen, device=gen.device).mul_(scale))
    return out


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02).to(dtype)


def wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or as it is if float64: where the JAX version computes in
    float32, the port does too, and in float64 when given float64 (a precision
    check's reference; the JAX package never sees float64)."""
    return t if t.dtype == torch.float64 else t.float()


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def apply_norm(x, p, norm_type: str):
    if norm_type == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_params(d: int, norm_type: str, dtype=torch.float32, device=None):
    if norm_type == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def stack_norm(cfg, n: int, device=None):
    """``n`` copies of ``cfg``'s norm params, stacked on a leading layer axis."""
    base = norm_params(cfg.d_model, cfg.norm_type, device=device)
    return {k: a.expand((n,) + a.shape).clone() for k, a in base.items()}


def unstack(tree, n: int) -> list[dict]:
    """The ``n`` per-layer trees of a layer-stacked param tree.

    Each stacked weight is unbound once, so under autograd its gradient is
    one ``stack`` of the ``n`` slice gradients.  Indexing ``w[i]`` per layer
    would instead allocate a zeroed full-size (L, ...) gradient for every
    layer and sum them.
    """
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = unstack(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def subtree(tree, path: str):
    """The subtree of ``tree`` at the dotted ``path`` (``"blocks.rec"``)."""
    for k in path.split("."):
        tree = tree[k]
    return tree


def depth(stack) -> int:
    """The layers of a layer-stacked tree: its leaves' leading dimension."""
    while isinstance(stack, dict):
        stack = next(iter(stack.values()))
    return stack.shape[0]


def run_sequence(cfg, seq, params, x, remat: bool = True, **kw) -> torch.Tensor:
    """Hidden states x (B, S, d) through the layers of ``seq``, a model module's
    ``layer_sequence`` ((stack, index, layer) in forward order), on the stacks of
    ``params``: each stack unbound once (``unstack``), and with ``remat`` and
    autograd on each layer under ``torch.utils.checkpoint``.  ``kw`` goes to
    every layer (``positions``, ``tp``)."""
    stacks: dict = {}
    checkpointed = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stack, i, layer in seq:
        if stack not in stacks:
            tree = subtree(params, stack)
            stacks[stack] = unstack(tree, depth(tree))
        lp = stacks[stack][i]
        if checkpointed:
            x, aux = torch.utils.checkpoint.checkpoint(layer, cfg, lp, x, aux,
                                                       use_reentrant=False, **kw)
        else:
            x, aux = layer(cfg, lp, x, aux, **kw)
    return x


def head(cfg, params, x, tp=None, return_hidden: bool = False):
    """(logits, 0.0) of the hidden states x (B, S, d) after the final norm: every
    position's, or with ``tp`` (a rank's ``TensorParallel``) the last one's over
    the whole vocab (``TensorParallel.logits``); with ``return_hidden`` the normed
    states in place of the logits.  The recurrent families' ``forward`` ends here."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return apply_norm(x, params["final_norm"], cfg.norm_type), zero
    if tp is None:
        return apply_norm(x, params["final_norm"], cfg.norm_type) @ unembed(params), zero
    return tp.logits(params, apply_norm(x[:, -1:], params["final_norm"], cfg.norm_type),
                     mask=True), zero


def unembed(params) -> torch.Tensor:
    """The (d, V) unembedding: ``params["unembed"]``, or the embedding's transpose when tied."""
    return params["unembed"] if "unembed" in params else params["embed"].T


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """x: (B, S, H, D); positions: (B, S) integer."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    angles = positions[..., None].float() * freqs  # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections, theta: float = 10_000.0):
    """Qwen2-VL multimodal RoPE: x (B, S, H, D), positions (3, B, S) for (t, h, w).

    Frequency band k rotates by ``positions[sec[k]]``, where ``sec`` repeats
    0, 1 and 2 by ``sections`` (which sum to D/2).  Text tokens carry
    t == h == w, where this is ``apply_rope``.  The JAX version also computes
    a ``take_along_axis`` of the positions whose result it never uses; it is
    left out here.
    """
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    # positions[sec] from the Python ints of ``sections``: no index tensor whose
    # values set a shape (a host sync on the card; a fake-tensor trace stops there)
    pos_bands = torch.cat([positions[band][None].expand(int(n), *positions.shape[1:])
                           for band, n in enumerate(sections)])  # (d/2, B, S)
    angles = pos_bands.permute(1, 2, 0).float() * freqs  # (B,S,d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, KV*groups, D) for GQA."""
    if groups == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(b, s, kv * groups, d)


def attention_dense(q, k, v, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Materialized-scores attention. q:(B,Sq,H,D), k/v:(B,Sk,KV,D)."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    sk = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_chunked(q, k, v, causal: bool = True, window: int = 0, chunk: int = 1024):
    """Online-softmax (flash-style) attention in plain torch.

    Loops over KV chunks keeping running (max, sum, acc): memory O(Sq·chunk)
    instead of O(Sq·Sk).  The CUDA kernel (``kernels/flash_attention``) is
    its fast twin.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    sk = k.shape[1]
    kvalid = sk
    if sk % chunk:
        pad = (-sk) % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        sk = k.shape[1]
    k = _repeat_kv(k, h // kv)
    v = _repeat_kv(v, h // kv)
    qf = (q / math.sqrt(d)).to(q.dtype)
    qpos = torch.arange(sq, device=q.device)

    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for ci in range(sk // chunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kb).float()
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = kpos[None, :] < kvalid
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > (qpos[:, None] - window))
        scores = torch.where(mask[None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        s = s * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype), vb
        ).float()
        m = m_new
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # (B,Sq,H,D)


def attention_decode(q, k_cache, v_cache, length: int, window: int = 0):
    """Single-token decode against a KV cache. q: (B, 1, H, D)."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    sk = k_cache.shape[1]
    k = _repeat_kv(k_cache, h // kv)
    v = _repeat_kv(v_cache, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(d), k).float()
    kpos = torch.arange(sk, device=q.device)
    mask = kpos < length
    if window:
        mask &= kpos >= (length - window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q, k, v, *, causal=True, window=0, chunk_threshold=2048, chunk=1024,
              use_kernel=False):
    """Dispatch kernel / dense / chunked attention, as the JAX package does.

    With ``use_kernel`` the flash-attention op runs (the CUDA kernel on the
    GPU); otherwise chunked beyond ``chunk_threshold`` keys, dense below.
    """
    if use_kernel:
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    if k.shape[1] > chunk_threshold:
        return attention_chunked(q, k, v, causal=causal, window=window, chunk=chunk)
    return attention_dense(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    h = F.gelu(x @ w_up + b_up, approximate="tanh")  # jax.nn.gelu's default
    return h @ w_down + b_down


# ---------------------------------------------------------------------------
# temporal conv (mamba2 / recurrentgemma)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv. x:(B,S,C), w:(W,C). Returns (y, new_state).

    ``state`` holds the ``W-1`` input rows before ``x`` (zeros when None); the
    new state is the last ``W-1`` rows of the padded input.  The taps are
    summed in the JAX version's order, each product in the input dtype.
    """
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return y.to(x.dtype), new_state
