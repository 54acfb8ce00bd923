"""RecurrentGemma / Griffin hybrid: ``repro.models.recurrentgemma`` in PyTorch.

RG-LRU recurrent blocks and local (sliding-window) MQA attention in a
2-recurrent : 1-attention repeating pattern, then a tail of recurrent layers
when the depth is not a multiple of the period.  The RG-LRU recurrence runs
as a log-depth inclusive scan over the sequence for training and prefill
(``_linear_scan``, where JAX runs ``lax.associative_scan``) and as a single
step for decode.  Decode state is constant-size: the LRU hidden state, the
conv tail and a rolling window of keys and values.

The parameter layout is the JAX package's (``blocks.rec``, ``blocks.attn``,
``tail``, each stacked on a leading layer axis), so
``repro_torch.testing.bridge`` moves weights one-to-one.  Attention is the
plain one (dense, or chunked beyond ``2·attn_chunk`` keys): ``forward``
accepts ``use_kernel`` and ignores it, as the JAX ``forward`` does through
``**_``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

C_RGLRU = 8.0  # Griffin's fixed recurrence-sharpness constant


def _layout(cfg: ArchConfig):
    """(period, n_blocks, recurrent layers in the blocks, tail layers)."""
    period = max(1, cfg.attention_period)
    n_blocks = cfg.n_layers // period
    return period, n_blocks, n_blocks * (period - 1), cfg.n_layers % period


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16):
    """Random weights on ``gen.device`` with the JAX version's layout and scales.

    The layer-stacked weights are drawn a layer at a time into ``dtype``
    (``layers.dense_init_by_layer``), so the peak is one layer's float32 slab
    above the weights.
    """
    d = cfg.d_model
    _, n_blocks, n_rec, tail = _layout(cfg)
    params = {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype=dtype),
        "blocks": {
            "rec": _rec_params(gen, cfg, n_rec, dtype),
            "attn": _attn_layer_params(gen, cfg, n_blocks, dtype),
        },
        "final_norm": L.norm_params(d, cfg.norm_type, device=gen.device),
    }
    if tail:
        params["tail"] = _rec_params(gen, cfg, tail, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (d, cfg.vocab), dtype=dtype)
    return params


def _rec_params(gen, cfg: ArchConfig, n: int, dtype):
    """n stacked recurrent layers (temporal block + MLP block)."""
    d = cfg.d_model
    dr = d  # lru width = d_model
    dev = gen.device
    return {
        "norm": L.stack_norm(cfg, n, dev),
        "w_gate_in": L.dense_init_by_layer(gen, (n, d, dr), dtype=dtype),
        "w_x_in": L.dense_init_by_layer(gen, (n, d, dr), dtype=dtype),
        "conv_w": (torch.randn((n, cfg.conv_width, dr), generator=gen, device=dev) * 0.1
                   ).to(dtype),
        "w_a": L.dense_init_by_layer(gen, (n, dr, dr), dtype=dtype),
        "w_i": L.dense_init_by_layer(gen, (n, dr, dr), dtype=dtype),
        "lambda_p": torch.full((n, dr), 0.5, dtype=torch.float32, device=dev),
        "w_out": L.dense_init_by_layer(gen, (n, dr, d), dtype=dtype),
        "mlp_norm": L.stack_norm(cfg, n, dev),
        **_mlp(gen, cfg, n, dtype),
    }


def _attn_layer_params(gen, cfg: ArchConfig, n: int, dtype):
    d, hd = cfg.d_model, cfg.kq_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "norm": L.stack_norm(cfg, n, gen.device),
        "wq": L.dense_init_by_layer(gen, (n, d, h * hd), dtype=dtype),
        "wk": L.dense_init_by_layer(gen, (n, d, kv * hd), dtype=dtype),
        "wv": L.dense_init_by_layer(gen, (n, d, kv * hd), dtype=dtype),
        "wo": L.dense_init_by_layer(gen, (n, h * hd, d), dtype=dtype),
        "mlp_norm": L.stack_norm(cfg, n, gen.device),
        **_mlp(gen, cfg, n, dtype),
    }


def _mlp(gen, cfg: ArchConfig, n: int, dtype):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": L.dense_init_by_layer(gen, (n, d, f), dtype=dtype),
        "w_up": L.dense_init_by_layer(gen, (n, d, f), dtype=dtype),
        "w_down": L.dense_init_by_layer(gen, (n, f, d), dtype=dtype),
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t along dim 1 from h_{-1} = 0, all t at once.

    Hillis–Steele: ⌈log₂ S⌉ rounds of elementwise ops, each combining every
    element with the one ``k`` before it under ``lax.associative_scan``'s
    combine (a1, b1) ∘ (a2, b2) = (a1·a2, b1·a2 + b2).  The combine order
    differs from JAX's, so float32 results differ by rounding only.
    """
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], b[:, :-k] * a[:, k:] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return b


def _gates(x, lp):
    """(a, gated input) of the RG-LRU in float32 (float64 for float64 x), x (B, S, Dr)."""
    r = torch.sigmoid(L.wide(x @ lp["w_a"]))
    i = torch.sigmoid(L.wide(x @ lp["w_i"]))
    a = torch.exp(-C_RGLRU * F.softplus(lp["lambda_p"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * L.wide(x))
    return a, gated


def rglru(x, lp, h0=None):
    """x: (B, S, Dr) conv output. Returns (y in x's dtype, final_state fp32 or fp64).

    a_t = exp(-c·softplus(Λ)·σ(W_a x_t));  gated input i_t = σ(W_i x_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙ x_t)
    """
    a, gated = _gates(x, lp)
    if h0 is not None:
        # fold the initial state into the first step
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0.to(a.dtype)[:, None], gated[:, 1:]],
                          dim=1)
    h = _linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rglru_step(x, lp, h0):
    """Single decode step: x (B, 1, Dr), h0 (B, Dr)."""
    a, gated = _gates(x, lp)
    h = a[:, 0] * h0.to(a.dtype) + gated[:, 0]
    return h[:, None].to(x.dtype), h


def _rec_layer(cfg: ArchConfig, lp, x, conv_state=None, lru_state=None, single_step=False):
    a = L.apply_norm(x, lp["norm"], cfg.norm_type)
    gate = F.gelu(a @ lp["w_gate_in"], approximate="tanh")  # jax.nn.gelu's default
    xin = a @ lp["w_x_in"]
    conv, new_conv = L.causal_conv1d(xin, lp["conv_w"], conv_state)
    if single_step:
        y, new_lru = rglru_step(conv, lp, lru_state)
    else:
        y, new_lru = rglru(conv, lp, lru_state)
    h = x + (y * gate) @ lp["w_out"]
    m = L.apply_norm(h, lp["mlp_norm"], cfg.norm_type)
    h = h + L.swiglu(m, lp["w_gate"], lp["w_up"], lp["w_down"])
    return h, new_conv, new_lru


def _qkv(cfg: ArchConfig, lp, a, positions):
    """Roped q (B,S,H,hd), k and v (B,S,KV,hd) of the normed input ``a``."""
    b, s, _ = a.shape
    hd = cfg.kq_head_dim
    q = (a @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (a @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (a @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _attn_out(cfg: ArchConfig, lp, x, o):
    """The residual after attention output ``o`` (B,S,H,hd), then the MLP block."""
    b, s = o.shape[:2]
    h = x + o.reshape(b, s, cfg.n_heads * cfg.kq_head_dim) @ lp["wo"]
    m = L.apply_norm(h, lp["mlp_norm"], cfg.norm_type)
    return h + L.swiglu(m, lp["w_gate"], lp["w_up"], lp["w_down"])


def _attn_layer(cfg: ArchConfig, lp, x, positions):
    a = L.apply_norm(x, lp["norm"], cfg.norm_type)
    q, k, v = _qkv(cfg, lp, a, positions)
    o = L.attention(q, k, v, causal=True, window=cfg.local_window,
                    chunk_threshold=cfg.attn_chunk * 2, chunk=cfg.attn_chunk)
    return _attn_out(cfg, lp, x, o)


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, remat: bool = True, **_):
    """Full forward pass -> (logits, 0.0), tokens (B, S) integer.

    With ``remat`` and autograd on, each (recurrent ×(period-1), attention)
    block runs under ``torch.utils.checkpoint``, as the JAX version checkpoints
    its scan body; the tail layers run outside it, as in JAX.  Other keywords
    (``use_kernel``, ``positions``) are accepted and ignored.
    """
    period, n_blocks, n_rec, _ = _layout(cfg)
    x = params["embed"][tokens.long()]
    b, s = tokens.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    rec = L.unstack(params["blocks"]["rec"], n_rec)
    attn = L.unstack(params["blocks"]["attn"], n_blocks)

    def block_fn(h, rps, ap):
        for lp in rps:
            h, _, _ = _rec_layer(cfg, lp, h)
        return _attn_layer(cfg, ap, h, positions)

    checkpointed = remat and torch.is_grad_enabled()
    for i in range(n_blocks):
        rps = rec[i * (period - 1):(i + 1) * (period - 1)]
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(block_fn, x, rps, attn[i],
                                                  use_reentrant=False)
        else:
            x = block_fn(x, rps, attn[i])
    if "tail" in params:
        tail_n = params["tail"]["lambda_p"].shape[0]
        for lp in L.unstack(params["tail"], tail_n):
            x, _, _ = _rec_layer(cfg, lp, x)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = x @ L.unembed(params)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# decode (constant-size state: LRU + conv + bounded attention window)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    _, n_blocks, n_rec, tail = _layout(cfg)
    dr, hd = cfg.d_model, cfg.kq_head_dim
    win = min(cfg.local_window, max_len)
    kv_shape = (n_blocks, batch, win, cfg.n_kv_heads, hd)
    return {
        "conv": torch.zeros((n_rec + tail, batch, cfg.conv_width - 1, dr), dtype=dtype,
                            device=device),
        "lru": torch.zeros((n_rec + tail, batch, dr), dtype=torch.float32, device=device),
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
        "len": 0,
    }


def decode_step(cfg: ArchConfig, params, cache, tokens, positions=None):
    """One-token decode: tokens (B, 1) -> (logits (B,1,V), cache).

    The key and value of position ``len`` go to slot ``len mod win`` of the
    rolling window, and attention reads the ``min(len + 1, win)`` filled
    slots.  As ``transformer.decode_step``, the cache passed in is written in
    place and returned, ``cache["len"]`` a Python int; the recurrent layers'
    states are indexed blocks first, then the tail, as in JAX.
    """
    period, n_blocks, n_rec, _ = _layout(cfg)
    b = tokens.shape[0]
    win = cache["k"].shape[2]
    pos = cache["len"]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    slot = pos % win  # rolling window write position
    x = params["embed"][tokens.long()]
    rec = L.unstack(params["blocks"]["rec"], n_rec)
    if "tail" in params:
        rec += L.unstack(params["tail"], params["tail"]["lambda_p"].shape[0])

    def rec_step(x, i):
        x, new_conv, new_lru = _rec_layer(cfg, rec[i], x, cache["conv"][i], cache["lru"][i],
                                          single_step=True)
        cache["conv"][i].copy_(new_conv)
        cache["lru"][i].copy_(new_lru)
        return x

    for blk, ap in enumerate(L.unstack(params["blocks"]["attn"], n_blocks)):
        for r in range(period - 1):
            x = rec_step(x, blk * (period - 1) + r)
        a = L.apply_norm(x, ap["norm"], cfg.norm_type)
        q, k, v = _qkv(cfg, ap, a, positions)
        kc, vc = cache["k"][blk], cache["v"][blk]
        kc[:, slot:slot + 1] = k
        vc[:, slot:slot + 1] = v
        o = L.attention_decode(q, kc, vc, min(pos + 1, win))
        x = _attn_out(cfg, ap, x, o)
    for i in range(n_rec, len(rec)):
        x = rec_step(x, i)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = x @ L.unembed(params)
    cache["len"] = pos + 1
    return logits, cache
