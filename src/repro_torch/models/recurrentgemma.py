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

The layers run in the order of ``layer_sequence`` ((rec × (period - 1),
attn) a block, then the tail), in ``forward``, ``decode_step`` and the
sharded train step's recompute.  Given the rank's ``Comm`` as
``act_specs["mesh"]`` and a ``Policy`` as ``act_specs["policy"]`` they run one
rank's share on its blocks of the parameters (``parallel/tensor_parallel.py``):
under a ``tp=True`` policy (the family's ``default_policy``) the recurrent
layer on the rank's Dr / n channels (the conv output all-gathered over
``model`` for ``w_a`` and ``w_i``, ``lambda_p`` read at the rank's channels),
the attention on whole heads (MQA: the lone kv head's columns moved with q's),
the MLP and the logits split as the transformer's; under a ``tp=False`` one
(``layout="fsdp"``) each layer gathered over ``data`` and run whole.  The decode
state then holds the rank's rows, its kv share of the window (``cache_heads``)
and its Dr / n channels of the conv and LRU states.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.parallel import tensor_parallel as tp_lib

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


def _gates(x, lp, full=None):
    """(a, gated input) of the RG-LRU in float32 (float64 for float64 x), x (B, S, Dr).
    With ``full`` (B, S, Dr) x is a rank's channels of it (tensor parallel), and
    ``lp`` holds the rank's columns of ``w_a``, ``w_i`` and ``lambda_p``."""
    src = x if full is None else full
    r = torch.sigmoid(L.wide(src @ lp["w_a"]))
    i = torch.sigmoid(L.wide(src @ lp["w_i"]))
    a = torch.exp(-C_RGLRU * F.softplus(lp["lambda_p"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * L.wide(x))
    return a, gated


def rglru(x, lp, h0=None, full=None):
    """x: (B, S, Dr) conv output. Returns (y in x's dtype, final_state fp32 or fp64).

    a_t = exp(-c·softplus(Λ)·σ(W_a x_t));  gated input i_t = σ(W_i x_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙ x_t)
    """
    a, gated = _gates(x, lp, full)
    if h0 is not None:
        # fold the initial state into the first step
        gated = torch.cat([gated[:, :1] + a[:, :1] * h0.to(a.dtype)[:, None], gated[:, 1:]],
                          dim=1)
    h = _linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rglru_step(x, lp, h0, full=None):
    """Single decode step: x (B, 1, Dr), h0 (B, Dr)."""
    a, gated = _gates(x, lp, full)
    h = a[:, 0] * h0.to(a.dtype) + gated[:, 0]
    return h[:, None].to(x.dtype), h


def _rec_layer(cfg: ArchConfig, lp, x, conv_state=None, lru_state=None, single_step=False,
               tp=None):
    """One recurrent layer; with ``tp`` (a view that splits over ``model``) on the
    rank's Dr / n channels (the module docstring), the states the rank's."""
    a = L.apply_norm(x, lp["norm"], cfg.norm_type)
    if tp is not None:  # replicated over model; the rank's columns give a part of d(a)
        a = tp.pvary(a)
    gate = F.gelu(a @ lp["w_gate_in"], approximate="tanh")  # jax.nn.gelu's default
    xin = a @ lp["w_x_in"]
    conv, new_conv = L.causal_conv1d(xin, lp["conv_w"], conv_state)
    full = None
    if tp is not None:
        full = tp.all_columns(conv)  # w_a and w_i contract over all of Dr
        c = conv.shape[-1]
        lp = {**lp, "lambda_p": tp.pvary(lp["lambda_p"])[tp.index * c:(tp.index + 1) * c]}
    scan = rglru_step if single_step else rglru
    y, new_lru = scan(conv, lp, lru_state, full)
    out = (y * gate) @ lp["w_out"]
    h = x + (out if tp is None else tp.sum(out))
    return _mlp_residual(cfg, lp, h, tp), new_conv, new_lru


def _qkv(cfg: ArchConfig, lp, a, positions, tp=None):
    """Roped q (B,S,H,hd), k and v (B,S,KV,hd) of the normed input ``a``; with
    ``tp`` whole heads of the rank's share (``TensorParallel.heads``)."""
    b, s, _ = a.shape
    hd = cfg.kq_head_dim
    if tp is None:
        q = (a @ lp["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = (a @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = (a @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    else:
        a = tp.pvary(a)
        q, k, v, positions = tp.heads(a @ lp["wq"], a @ lp["wk"], a @ lp["wv"], positions)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _attn_out(cfg: ArchConfig, lp, x, o, tp=None):
    """The residual after attention output ``o`` (B,S,H,hd), then the MLP block;
    with ``tp`` ``o`` is the rank's share, moved back to its columns."""
    b, s = x.shape[:2]
    if tp is None:
        h = x + o.reshape(b, s, cfg.n_heads * cfg.kq_head_dim) @ lp["wo"]
    else:
        h = x + tp.sum(tp.columns(o, b) @ lp["wo"])
    return _mlp_residual(cfg, lp, h, tp)


def _mlp_residual(cfg: ArchConfig, lp, h, tp=None):
    """h plus the MLP block of ``mlp_norm(h)`` (with ``tp`` split over ``model``)."""
    m = L.apply_norm(h, lp["mlp_norm"], cfg.norm_type)
    return h + (L.swiglu(m, lp["w_gate"], lp["w_up"], lp["w_down"]) if tp is None
                else tp.mlp(lp, m))


def _attn_layer(cfg: ArchConfig, lp, x, positions, tp=None):
    a = L.apply_norm(x, lp["norm"], cfg.norm_type)
    q, k, v = _qkv(cfg, lp, a, positions, tp)
    o = L.attention(q, k, v, causal=True, window=cfg.local_window,
                    chunk_threshold=cfg.attn_chunk * 2, chunk=cfg.attn_chunk)
    return _attn_out(cfg, lp, x, o, tp)


def _rec(stack: str):
    """The ``layer_sequence`` entry of a recurrent layer of ``stack``."""

    def layer(cfg, lp, h, aux, positions=None, enc=None, use_kernel=False, tp=None):
        if tp is not None:
            lp = tp.layer(lp, stack)
        return _rec_layer(cfg, lp, h, tp=None if tp is None else tp.model_view)[0], aux

    return layer


def _attn(cfg, lp, h, aux, positions=None, enc=None, use_kernel=False, tp=None):
    """The ``layer_sequence`` entry of an attention layer."""
    if tp is not None:
        lp = tp.layer(lp, "blocks.attn")
    return _attn_layer(cfg, lp, h, positions, None if tp is None else tp.model_view), aux


_REC, _TAIL = _rec("blocks.rec"), _rec("tail")


def layer_sequence(cfg: ArchConfig) -> list:
    """(stack, index, layer) of every layer in forward order (``transformer.
    layer_sequence``'s signature): a block's recurrent layers from ``blocks.rec``,
    then its attention layer from ``blocks.attn``, for each block; then ``tail``."""
    period, n_blocks, _, tail = _layout(cfg)
    seq = []
    for blk in range(n_blocks):
        seq += [("blocks.rec", blk * (period - 1) + r, _REC) for r in range(period - 1)]
        seq.append(("blocks.attn", blk, _attn))
    return seq + [("tail", i, _TAIL) for i in range(tail)]


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, remat: bool = True, act_specs=None,
            return_hidden: bool = False, **_):
    """Full forward pass -> (logits, 0.0), tokens (B, S) integer.

    With ``remat`` and autograd on, each layer runs under
    ``torch.utils.checkpoint``, as the JAX version checkpoints its scan body
    (there a block, the tail outside it; the values are the same).  Other
    keywords (``use_kernel``, ``positions``) are accepted and ignored.  With
    ``return_hidden`` the final-norm hidden states come back in place of the
    logits.  With a sharded ``act_specs`` (the module docstring) ``params`` are
    the rank's blocks and ``tokens`` its rows; the logits come back for the last
    position only, (B, 1, V), the whole vocab on every rank along ``model``.
    """
    tp = tp_lib.context(cfg, act_specs)
    if tp is not None:
        tp.check(params)
    x = params["embed"][tokens.long()] if tp is None else tp.embed(params, tokens)
    b, s = tokens.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    x = L.run_sequence(cfg, layer_sequence(cfg), params, x, remat, positions=positions, tp=tp)
    return L.head(cfg, params, x, tp, return_hidden)


# ---------------------------------------------------------------------------
# decode (constant-size state: LRU + conv + bounded attention window)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               act_specs=None):
    """Zero states.  With a sharded ``act_specs`` (``forward``) the rank's: under a
    ``tp=True`` policy the window's (rows, kv heads) of ``cache_heads`` and Dr / n
    channels of ``conv`` and ``lru``."""
    _, n_blocks, n_rec, tail = _layout(cfg)
    tp = tp_lib.context(cfg, act_specs)
    split = None if tp is None else tp.model_view
    rows, kv = (batch, cfg.n_kv_heads) if split is None else split.cache_heads(batch)
    dr, hd = cfg.d_model // (1 if split is None else split.n), cfg.kq_head_dim
    win = min(cfg.local_window, max_len)
    kv_shape = (n_blocks, rows, win, kv, hd)
    return {
        "conv": torch.zeros((n_rec + tail, batch, cfg.conv_width - 1, dr), dtype=dtype,
                            device=device),
        "lru": torch.zeros((n_rec + tail, batch, dr), dtype=torch.float32, device=device),
        "k": torch.zeros(kv_shape, dtype=dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=dtype, device=device),
        "len": 0,
    }


def decode_step(cfg: ArchConfig, params, cache, tokens, positions=None, act_specs=None):
    """One-token decode: tokens (B, 1) -> (logits (B,1,V), cache).

    The key and value of position ``len`` go to slot ``len mod win`` of the
    rolling window, and attention reads the ``min(len + 1, win)`` filled
    slots.  As ``transformer.decode_step``, the cache passed in is written in
    place and returned, ``cache["len"]`` a Python int; the recurrent layers'
    states are indexed blocks first, then the tail, as in JAX.  With a sharded
    ``act_specs`` ``params`` are the rank's blocks, ``tokens`` its rows and
    ``cache`` its ``init_cache``; the logits are the whole vocab's on every rank
    along ``model``.
    """
    _, _, n_rec, _ = _layout(cfg)
    tp = tp_lib.context(cfg, act_specs)
    split = None if tp is None else tp.model_view
    if tp is not None:
        tp.check(params)
    b = tokens.shape[0]
    win = cache["k"].shape[2]
    pos = cache["len"]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    slot = pos % win  # rolling window write position
    x = params["embed"][tokens.long()] if tp is None else tp.embed(params, tokens)
    stacks: dict = {}
    for stack, i, _ in layer_sequence(cfg):
        if stack not in stacks:
            tree = L.subtree(params, stack)
            stacks[stack] = L.unstack(tree, L.depth(tree))
        lp = stacks[stack][i] if tp is None else tp.layer(stacks[stack][i], stack)
        if stack != "blocks.attn":
            j = i if stack == "blocks.rec" else n_rec + i
            x, new_conv, new_lru = _rec_layer(cfg, lp, x, cache["conv"][j], cache["lru"][j],
                                              single_step=True, tp=split)
            cache["conv"][j].copy_(new_conv)
            cache["lru"][j].copy_(new_lru)
            continue
        a = L.apply_norm(x, lp["norm"], cfg.norm_type)
        q, k, v = _qkv(cfg, lp, a, positions, split)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, slot:slot + 1] = k
        vc[:, slot:slot + 1] = v
        o = L.attention_decode(q, kc, vc, min(pos + 1, win))
        x = _attn_out(cfg, lp, x, o, split)
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = x @ L.unembed(params) if tp is None else tp.logits(params, x, mask=False)
    cache["len"] = pos + 1
    return logits, cache
