"""Transformer LMs: the dense, MoE, VLM and audio families of ``repro.models.transformer``.

The parameter layout is the JAX package's: a nested dict with the per-layer
weights stacked on a leading L axis (``params["layers"]["wq"]`` is
(L, d, H·hd)), so ``repro_torch.testing.bridge`` moves weights one-to-one.
Layers run as a Python loop over that axis, each stacked weight unbound once
per call.  ``DenseLM`` holds the stacked parameters as an ``nn.Module`` and
delegates to the functions here.

The MoE family replaces each layer's SwiGLU with ``models.moe`` under
``params["layers"]["moe"]`` (an fp32 router beside experts in the model's
dtype) and returns the load-balancing loss averaged over the layers.  Its
expert-parallel mode (``moe_mode="ep"``) runs ``forward`` once a rank of a
``core.comm`` mesh with a ``"model"`` axis, the rank's ``Comm`` given as
``act_specs["mesh"]`` where JAX gives its mesh.  The VLM family
(qwen2-vl) rotates by M-RoPE over (3, B, S) positions.  The audio family
(whisper) is an encoder-decoder: learned positions, an encoder over
precomputed frames (B, enc_seq, d), and a cross-attention in every decoder
layer whose decode cache ``xk``/``xv`` is zeros, as in JAX.  The SSM and
hybrid families have modules of their own (``mamba2``, ``recurrentgemma``).

The four families also run sharded: given the rank's ``Comm`` as
``act_specs["mesh"]`` and a ``Policy`` as ``act_specs["policy"]``, ``forward``,
``init_cache`` and ``decode_step`` run one rank's share on its blocks of the
parameters (``parallel/tensor_parallel.py``), through the same
``decoder_layer``, ``_attn_block``, ``_mlp_block`` and encoder, where JAX's
jitted steps leave the split to GSPMD; under autograd too (training,
``train/steps.py``).  Under a ``tp=True`` policy the layers split over
``model`` (the MoE's experts on d_ff, ``moe.moe_apply_tp``, or under
``moe_mode`` "ep" and "gshard" on E: ``_moe_view``; the audio family's encoder
and decoder self-attention and gelu MLPs alike, its cross-attention whole on
every rank); under a ``tp=False`` one they gather their FSDP leaves and run
whole, but for EP, which cuts the rank's E / n experts.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.parallel import tensor_parallel as tp_lib

# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def _attn_params(gen, cfg: ArchConfig, n_layers: int, dtype):
    d, hd = cfg.d_model, cfg.kq_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": L.dense_init(gen, (n_layers, d, h * hd), dtype=dtype),
        "wk": L.dense_init(gen, (n_layers, d, kv * hd), dtype=dtype),
        "wv": L.dense_init(gen, (n_layers, d, kv * hd), dtype=dtype),
        "wo": L.dense_init(gen, (n_layers, h * hd, d), dtype=dtype),
    }


def _mlp_params(gen, cfg: ArchConfig, n_layers: int, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": L.dense_init(gen, (n_layers, d, f), dtype=dtype),
            "w_up": L.dense_init(gen, (n_layers, d, f), dtype=dtype),
            "w_down": L.dense_init(gen, (n_layers, f, d), dtype=dtype),
        }
    return {
        "w_up": L.dense_init(gen, (n_layers, d, f), dtype=dtype),
        "b_up": torch.zeros((n_layers, f), dtype=dtype, device=gen.device),
        "w_down": L.dense_init(gen, (n_layers, f, d), dtype=dtype),
        "b_down": torch.zeros((n_layers, d), dtype=dtype, device=gen.device),
    }


def _moe_params(gen, cfg: ArchConfig, n_layers: int, dtype):
    """The router in float32 whatever ``dtype``, as in JAX; the expert stacks
    (L, E, ...) drawn a layer at a time (``layers.dense_init_by_layer``)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": L.dense_init(gen, (n_layers, d, e), dtype=torch.float32),
        "w_gate": L.dense_init_by_layer(gen, (n_layers, e, d, f), dtype=dtype),
        "w_up": L.dense_init_by_layer(gen, (n_layers, e, d, f), dtype=dtype),
        "w_down": L.dense_init_by_layer(gen, (n_layers, e, f, d), dtype=dtype),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16):
    """Random weights on ``gen.device``, drawn from ``gen`` in a fixed order.

    The layout and scales are the JAX package's; the numbers are not, since a
    torch.Generator and a jax.random key give different draws from one seed.
    """
    d = cfg.d_model
    layer = {
        "attn_norm": L.stack_norm(cfg, cfg.n_layers, gen.device),
        "mlp_norm": L.stack_norm(cfg, cfg.n_layers, gen.device),
        **_attn_params(gen, cfg, cfg.n_layers, dtype),
    }
    if cfg.family == "moe":
        layer["moe"] = _moe_params(gen, cfg, cfg.n_layers, dtype)
    else:
        layer.update(_mlp_params(gen, cfg, cfg.n_layers, dtype))
    params = {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype=dtype),
        "layers": layer,
        "final_norm": L.norm_params(d, cfg.norm_type, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (d, _padded_vocab(cfg)), dtype=dtype)
    if cfg.rope_type == "learned":
        params["pos_embed"] = L.embed_init(gen, (cfg.max_pos, d), dtype=dtype)
    if cfg.enc_layers:
        params["encoder"] = {
            "layers": {
                "attn_norm": L.stack_norm(cfg, cfg.enc_layers, gen.device),
                "mlp_norm": L.stack_norm(cfg, cfg.enc_layers, gen.device),
                **_attn_params(gen, cfg, cfg.enc_layers, dtype),
                **_mlp_params(gen, cfg, cfg.enc_layers, dtype),
            },
            "final_norm": L.norm_params(d, cfg.norm_type, device=gen.device),
            "pos_embed": L.embed_init(gen, (cfg.enc_seq, d), dtype=dtype),
        }
        layer["xattn_norm"] = L.stack_norm(cfg, cfg.n_layers, gen.device)
        layer.update({f"x{k}": v for k, v in _attn_params(gen, cfg, cfg.n_layers,
                                                          dtype).items()})
    return params


def _padded_vocab(cfg: ArchConfig) -> int:
    if not cfg.vocab_pad_to:
        return cfg.vocab
    p = cfg.vocab_pad_to
    return (cfg.vocab + p - 1) // p * p


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _positions_default(tokens):
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def _apply_pos(cfg, q, k, positions):
    if cfg.rope_type not in ("rope", "mrope"):
        return q, k
    with trace.span("rope"):
        if cfg.rope_type == "rope":
            return (
                L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta),
            )
        return (
            L.apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta),
            L.apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta),
        )


def _norm(cfg: ArchConfig, x, p):
    """``layers.apply_norm`` of a decoder layer or the head, under the ``norm`` span."""
    with trace.span("norm"):
        return L.apply_norm(x, p, cfg.norm_type)


def _attn_block(cfg: ArchConfig, p, x, positions, causal, window, kv_seq=None,
                use_kernel=False, tp=None):
    """p holds per-layer (unstacked) attention params.  With ``kv_seq`` (the
    encoder's output) k and v come from it and nothing is rotated.  With ``tp``
    (the rank's ``tensor_parallel.TensorParallel``) p holds the rank's columns
    and rows: q, k and v move to the whole heads of the rank's share before
    RoPE, and the output back to its columns before ``wo`` and the sum."""
    b, s, d = x.shape
    hd = cfg.kq_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    src = x if kv_seq is None else kv_seq
    if tp is None:
        q = (x @ p["wq"]).reshape(b, s, h, hd)
        k = (src @ p["wk"]).reshape(b, src.shape[1], kv, hd)
        v = (src @ p["wv"]).reshape(b, src.shape[1], kv, hd)
    else:  # x is replicated over model; the rank's columns give a part of d(x)
        x = tp.pvary(x)
        q, k, v, positions = tp.heads(x @ p["wq"], x @ p["wk"], x @ p["wv"], positions)
    if kv_seq is None:
        q, k = _apply_pos(cfg, q, k, positions)
    o = L.attention(
        q, k, v, causal=causal, window=window,
        chunk_threshold=cfg.attn_chunk * 2, chunk=cfg.attn_chunk,
        use_kernel=use_kernel,
    )
    if tp is not None:
        return tp.sum(tp.columns(o, b) @ p["wo"])
    return o.reshape(b, s, h * hd) @ p["wo"]


def _mlp_block(cfg: ArchConfig, p, x, tp=None):
    with trace.span("mlp") as sp:
        x = sp.inputs(x)
        if tp is not None:
            y = tp.mlp(p, x)
        elif cfg.act == "swiglu":
            y = L.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
        else:
            y = L.gelu_mlp(x, p["w_up"], p["b_up"], p["w_down"], p["b_down"])
        return sp.outputs(y)


def _moe_ep(cfg: ArchConfig, mp, x, comm):
    """Expert-parallel MoE on one rank: the body of JAX's ``shard_map`` over
    ``"model"`` (tokens and router replicated, experts split).  ``mp`` holds every
    expert, as the global arrays JAX's ``in_specs`` cut; the rank takes its
    ``E / n`` of them (views, no copy).  ``pvary`` and ``replicated_out`` give the
    gradients JAX's transpose gives: the replicated inputs' summed over the
    ranks, the experts' each on its own rank."""
    n, i = comm.axis_size("model"), comm.axis_index("model")
    e = mp["w_gate"].shape[0]
    if e != cfg.n_experts or e % n:
        raise ValueError(f"{cfg.name}: moe_mode='ep' takes all {cfg.n_experts} experts, "
                         f"split over {n} ranks; got {e}")
    el = e // n
    local = {"router": comm.pvary(mp["router"], "model"),
             **{w: mp[w][i * el:(i + 1) * el] for w in ("w_gate", "w_up", "w_down")}}
    y, aux = moe_lib.moe_apply_ep(comm, comm.pvary(x, "model"), local, cfg.top_k,
                                  cfg.capacity_factor, axis="model")
    return comm.replicated_out(y, "model"), comm.replicated_out(aux, "model")


def _moe_block(cfg: ArchConfig, mp, x, act_specs=None, tp=None):
    """(y, aux) of one MoE layer in the forward pass, by ``cfg.moe_mode``; with
    ``tp`` (the rank's view) on the rank's experts (``_moe_view``)."""
    if tp is not None:
        return _moe_view(cfg, tp, mp, x)
    if cfg.moe_mode == "ep":
        comm = (act_specs or {}).get("mesh")
        if comm is None:
            raise ValueError(f"{cfg.name}: moe_mode='ep' needs the rank's core.comm Comm "
                             "as act_specs['mesh'] (forward inside Mesh.run)")
        return _moe_ep(cfg, mp, x, comm)
    if cfg.moe_mode == "gshard":
        return moe_lib.moe_apply_gshard(x, mp, cfg.top_k, cfg.capacity_factor,
                                        expert_spec=(act_specs or {}).get("experts"))
    return moe_lib.moe_apply(x, mp, cfg.top_k, cfg.capacity_factor)


def _moe_view(cfg: ArchConfig, tp, mp, x, decode: bool = False):
    """(y, aux) of one MoE layer on a rank's view, ``mp`` its layer's experts with
    FSDP undone (``TensorParallel.layer``):

    * ``moe_mode="tp"`` under a ``tp=True`` policy: the experts split on d_ff,
      ``moe.moe_apply_tp``;
    * experts split on E over ``model`` (``"ep"`` or ``"gshard"`` under a
      ``tp=True`` policy, E dividing ``model``): ``moe.moe_apply_gshard_tp`` for
      gshard, and in decode for both;
    * ``"ep"`` in the forward pass: ``_moe_ep_view``, on the rank's E / n
      experts (split at rest, or cut from whole ones as the layer is gathered);
    * else (every expert whole on the rank: a ``tp=False`` policy, or E not
      dividing ``model``) the family's own layer on them: ``moe_apply_gshard``
      for gshard, ``moe_apply`` otherwise, nothing summed over ``model``.

    In ``decode`` JAX runs ``moe_apply`` whatever ``moe_mode``: the gshard-TP
    rule computes its function, and whole experts run it."""
    k, cf = cfg.top_k, cfg.capacity_factor
    if cfg.moe_mode == "tp" and tp.tp:
        return moe_lib.moe_apply_tp(tp, x, mp, k, cf)
    if tp.plan.experts_split and (decode or cfg.moe_mode == "gshard"):
        return moe_lib.moe_apply_gshard_tp(tp, x, mp, k, cf)
    if cfg.moe_mode == "ep" and not decode:
        return _moe_ep_view(cfg, tp, mp, x)
    if cfg.moe_mode == "gshard" and not decode:
        return moe_lib.moe_apply_gshard(x, mp, k, cf)
    return moe_lib.moe_apply(x, mp, k, cf)


def _moe_ep_view(cfg: ArchConfig, tp, mp, x):
    """``moe.moe_apply_ep`` among the ranks along ``model`` on a view: ``mp`` the
    router and the rank's E / n experts, ``x`` the rank's rows.  Its all-to-alls
    are the view's (``TensorParallel.exchange``: cuts of the tape on the cut
    route, their own transpose).

    The whole batch is one dispatch group, as in the reference's shard_map
    body, whose data axes are automatic: the rows of every rank along
    ``tp.ep_axes`` (the data axes; none under a sync mode) in the order of the
    batch, each rank keeping its own, their per-expert counts and router sums
    gathered there (``TensorParallel.gather``: its transpose reduce-scatters,
    so that the group's aux loss reaches every rank's router).

    Where the tokens are the same on every rank along ``model`` (``model`` not
    a data axis: the 2d layout, JAX's ``in_specs=P()``), every rank routes them
    alike and runs its experts on ``model`` identical copies of their slabs, as
    the reference's shard_map body does; the output goes out as replicated
    (``Comm.replicated_out``: its gradient divided by ``model``, so that the
    copies' gradients add up to one), and the slabs' tokens and the gates
    enter through ``pvary``, whose transpose sums the ranks' parts, so that x's
    and the router's gradients are whole on every rank.  Under
    ``layout="fsdp"`` (``model`` a data axis) each rank holds rows of its own."""
    replicated = tp.axis not in tp.data_axes
    axes, group = tp.ep_axes, None
    if tp.comm.axis_size(axes) > 1:
        group = (lambda v: tp.gather(v, axes), tp.comm.axis_index(axes))
    y, aux = moe_lib.moe_apply_ep(tp.comm, x, mp, cfg.top_k, cfg.capacity_factor, tp.axis,
                                  exchange=lambda t: tp.exchange(t, None),
                                  vary=tp.pvary if replicated else None, group=group)
    return (tp.comm.replicated_out(y, tp.axis) if replicated else y), aux


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    positions: torch.Tensor | None = None,
    encoder_frames: torch.Tensor | None = None,
    remat: bool = True,
    use_kernel: bool = False,
    act_specs=None,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full forward pass -> (logits, moe_aux_loss), tokens (B, S) integer.

    For the VLM family (M-RoPE) ``positions`` is (3, B, S); for the audio
    family ``encoder_frames`` (B, enc_seq, d), the output of the (stubbed)
    conv frontend, is required.  With ``remat`` and autograd on, each layer
    (the encoder's too) runs under ``torch.utils.checkpoint`` (the
    counterpart of ``jax.checkpoint`` around the JAX layer): only its inputs
    are kept, and the backward pass runs the layer again.  Without autograd
    (serving) it has no effect.  Each layer carries (h, aux), as the JAX scan
    does; the MoE loss comes back averaged over the layers (zero for the
    other families).  With ``return_hidden`` the final-norm hidden states
    (B, S, d) come back in place of the logits, for the chunked
    cross-entropy.  ``use_kernel`` takes the flash op in the decoder's
    self-attention only: the encoder and the cross-attention stay plain, as
    in JAX.  ``act_specs`` is JAX's: its ``"act"``, ``"logits"`` and
    ``"experts"`` anchors constrain layouts only, and with no layout here they
    are accepted and change no number; ``"mesh"`` is read for
    ``moe_mode="ep"`` (``_moe_ep``).

    The sharded path (``parallel/tensor_parallel.py``): with
    ``act_specs["policy"]`` a ``Policy`` and ``act_specs["mesh"]`` the rank's
    ``Comm`` (inside ``Mesh.run``), ``params`` are the rank's blocks under
    ``sanitize_specs(param_specs(...))`` and ``tokens``, ``positions`` and
    ``encoder_frames`` its rows under ``batch_specs``; the logits come back for
    the last position only, (B, 1, V), the whole vocab on every rank along
    ``model``; with ``return_hidden`` the final-norm hidden states of every
    position, which ``TensorParallel.loss_sum`` takes.  ``remat`` acts as above, the
    recomputed layer running its collectives again (``train/steps.py:
    make_tp_value_and_grad`` is the route that keeps every collective out of
    autograd).
    """
    tp = tp_lib.context(cfg, act_specs)
    if tp is not None:
        return _forward_tp(cfg, tp, params, tokens, positions, encoder_frames, remat,
                           use_kernel, return_hidden)
    if positions is None:
        positions = default_positions(cfg, tokens)
    x = embed(cfg, params, tokens)
    enc_out = None
    if cfg.enc_layers:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name}: the audio family needs encoder frames")
        enc_out = _encoder_forward(cfg, params["encoder"], encoder_frames,
                                   remat and torch.is_grad_enabled())

    x, aux = forward_layers(cfg, params["layers"], x, positions, enc_out, remat=remat,
                            use_kernel=use_kernel, act_specs=act_specs)
    aux = aux / cfg.n_layers
    with trace.span("head") as sp:
        x = _norm(cfg, sp.inputs(x), params["final_norm"])
        if return_hidden:
            return sp.outputs(x), aux
        logits = x @ L.unembed(params)
        if logits.shape[-1] != cfg.vocab:  # padded vocab: mask the tail
            keep = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
            logits = torch.where(keep, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                            device=logits.device))
        return sp.outputs(logits), aux


def _forward_tp(cfg: ArchConfig, tp, params, tokens, positions, encoder_frames, remat,
                use_kernel, return_hidden):
    """``forward`` on the rank's blocks (``tensor_parallel``): the last position's
    logits, or the final-norm hidden states with ``return_hidden``."""
    tp.check(params)
    x = embed(cfg, params, tokens, tp)
    enc_out = None
    if cfg.enc_layers:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name}: the audio family needs encoder frames")
        enc_out = _encoder_forward(cfg, params["encoder"], encoder_frames,
                                   remat and torch.is_grad_enabled(), tp)
    x, aux = forward_layers(cfg, params["layers"], x, positions, enc_out, remat=remat,
                            use_kernel=use_kernel, tp=tp)
    if return_hidden:
        return L.apply_norm(x, params["final_norm"], cfg.norm_type), aux / cfg.n_layers
    x = L.apply_norm(x[:, -1:], params["final_norm"], cfg.norm_type)
    return tp.logits(params, x, mask=True), aux / cfg.n_layers


def embed(cfg: ArchConfig, params, tokens, tp=None):
    """The embedding of tokens (B, S), plus the learned positions; with ``tp`` from
    the rank's blocks (the vocab-parallel lookup, FSDP undone)."""
    if tp is None:
        x = params["embed"][tokens.long()]
        pos_embed = params.get("pos_embed")
    else:
        x = tp.embed(params, tokens)
        pos_embed = tp.whole(params["pos_embed"], "pos_embed") if "pos_embed" in params else None
    if cfg.rope_type == "learned":
        x = x + pos_embed[: x.shape[1]][None]
    return x


def default_positions(cfg: ArchConfig, x):
    """0 .. S-1 for every row of x (B, S, ...): (B, S), or (3, B, S) under M-RoPE."""
    positions = _positions_default(x)
    if cfg.rope_type == "mrope":
        positions = positions.expand(3, *positions.shape)
    return positions


def forward_layers(cfg: ArchConfig, layers, x, positions=None, enc_out=None, remat=True,
                   use_kernel=False, act_specs=None, tp=None):
    """The decoder layers of a stack (the leading axis of every leaf of ``layers``;
    all of the model's, or a pipeline stage's) over hidden states x (B, S, d) ->
    (x, the MoE loss summed over these layers).  ``forward`` without the embed,
    final norm and unembed; the arguments are ``forward``'s.  With ``tp`` (or a
    tensor-parallel ``act_specs``) ``layers`` holds the rank's blocks, and each
    layer's are all-gathered over ``data`` as it runs."""
    tp = tp or tp_lib.context(cfg, act_specs)
    if positions is None:
        positions = default_positions(cfg, x)
    checkpointed = remat and torch.is_grad_enabled()

    def layer_fn(h, aux, lp, enc):
        return decoder_layer(cfg, lp, h, aux, positions, enc, use_kernel, act_specs, tp)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n = layers["attn_norm"]["scale"].shape[0]
    for lp in L.unstack(layers, n):
        if checkpointed:
            x, aux = torch.utils.checkpoint.checkpoint(layer_fn, x, aux, lp, enc_out,
                                                       use_reentrant=False)
        else:
            x, aux = layer_fn(x, aux, lp, enc_out)
    return x, aux


def layer_sequence(cfg: ArchConfig) -> list:
    """(stack, index, layer) of every decoder layer in forward order: the
    ``layers`` stack's, each run by ``decoder_layer``.  ``layer(cfg, lp, h, aux,
    positions, enc, use_kernel, tp) -> (h, aux)`` is the signature every family's
    sequence shares (``train/steps.py: make_tp_value_and_grad`` walks it)."""
    return [("layers", i, decoder_layer) for i in range(cfg.n_layers)]


def decoder_layer(cfg: ArchConfig, lp, h, aux, positions, enc=None, use_kernel=False,
                  act_specs=None, tp=None):
    """One decoder layer of ``forward_layers`` on its (unstacked) weights ``lp``:
    (h, aux) -> (h, aux plus the layer's MoE loss).  With ``tp`` ``lp`` holds
    the rank's blocks, all-gathered over ``data`` here; the products split over
    ``model`` under a ``tp=True`` view, and run whole under a ``tp=False`` one."""
    split_tp = None if tp is None else tp.model_view
    with trace.span("layer") as sp:
        h, aux = sp.inputs(h, aux)
        if tp is not None:
            lp = tp.layer(lp)
        a = _norm(cfg, h, lp["attn_norm"])
        h = h + _attn_block(cfg, lp, a, positions, causal=True, window=0,
                            use_kernel=use_kernel, tp=split_tp)
        if enc is not None:
            xa = _norm(cfg, h, lp["xattn_norm"])
            xp = {k[1:]: v for k, v in lp.items() if k.startswith("x") and k != "xattn_norm"}
            h = h + _attn_block(cfg, xp, xa, positions, causal=False, window=0, kv_seq=enc)
        m = _norm(cfg, h, lp["mlp_norm"])
        if cfg.family == "moe":
            y, a_loss = _moe_block(cfg, lp["moe"], m, act_specs, tp)
            aux = aux + a_loss
        else:
            y = _mlp_block(cfg, lp, m, split_tp)
        return sp.outputs(h + y, aux)


def encoder_embed(cfg: ArchConfig, enc, frames, tp=None):
    """The encoder's input: frames in ``pos_embed``'s dtype plus the learned
    positions (with ``tp`` ``enc`` holds the rank's blocks, FSDP undone here)."""
    pos_embed = enc["pos_embed"] if tp is None else tp.whole(enc["pos_embed"], "encoder",
                                                             "pos_embed")
    return frames.to(pos_embed.dtype) + pos_embed[: frames.shape[1]][None]


def encoder_layer(cfg: ArchConfig, lp, h, tp=None):
    """One encoder layer on its (unstacked) weights ``lp``: non-causal
    self-attention (plain, never the kernel, as in JAX) and a gelu MLP.  With
    ``tp`` ``lp`` holds the rank's blocks, all-gathered over ``data`` here; under a
    ``tp=True`` view both split over ``model`` as the decoder's do."""
    split_tp = None if tp is None else tp.model_view
    if tp is not None:
        lp = tp.layer(lp, "encoder.layers")
    a = L.apply_norm(h, lp["attn_norm"], cfg.norm_type)
    h = h + _attn_block(cfg, lp, a, _positions_default(h), causal=False, window=0,
                        tp=split_tp)
    m = L.apply_norm(h, lp["mlp_norm"], cfg.norm_type)
    return h + _mlp_block(cfg, lp, m, split_tp)


def _encoder_forward(cfg: ArchConfig, enc, frames, checkpointed: bool, tp=None):
    """The audio encoder: ``encoder_embed``, ``enc_layers`` of ``encoder_layer``,
    then the final norm."""
    x = encoder_embed(cfg, enc, frames, tp)
    for lp in L.unstack(enc["layers"], cfg.enc_layers):
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(encoder_layer, cfg, lp, x, tp,
                                                  use_reentrant=False)
        else:
            x = encoder_layer(cfg, lp, x, tp)
    return L.apply_norm(x, enc["final_norm"], cfg.norm_type)


# ---------------------------------------------------------------------------
# KV-cache serving path
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None, act_specs=None):
    """Zero K/V caches (L, B, max_len, KV, hd) and ``len`` 0; for the audio
    family also the cross-attention's ``xk``/``xv`` (L, B, enc_seq, KV, hd),
    which stay zero, as in JAX (``decode_step``).  With a sharded ``act_specs``
    (``forward``) the rank's cache of its ``batch`` rows: under a ``tp=True``
    policy's pair route (L, rows, max_len, kv heads, hd) of its share, else every
    kv head (``tensor_parallel``); ``xk``/``xv`` under a ``tp=True`` policy
    ``cache_specs``' block (``TensorParallel.cross_cache_shape``)."""
    hd = cfg.kq_head_dim
    tp = tp_lib.context(cfg, act_specs)
    split_tp = None if tp is None else tp.model_view
    rows, kv = (batch, cfg.n_kv_heads) if split_tp is None else split_tp.cache_heads(batch)
    shape = (cfg.n_layers, rows, max_len, kv, hd)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }
    if cfg.enc_layers:
        xshape = ((cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads, hd) if split_tp is None
                  else split_tp.cross_cache_shape(cfg.n_layers, batch))
        cache["xk"] = torch.zeros(xshape, dtype=dtype, device=device)
        cache["xv"] = torch.zeros(xshape, dtype=dtype, device=device)
    return cache


def decode_step(cfg: ArchConfig, params, cache, tokens, positions=None, act_specs=None):
    """One-token decode: tokens (B, 1) -> (logits (B,1,V), cache).

    Unlike the JAX version, which returns a new cache, this writes the new
    keys and values into ``cache["k"]``/``cache["v"]`` in place and advances
    ``cache["len"]``, a Python int, so a step needs no copy of the cache and
    no host sync.  The cache passed in is the one returned.  Past the cache's
    end the step writes its last slot, as ``lax.dynamic_update_slice`` clamps
    its index, while ``len`` and the RoPE position go on counting; the
    learned position clamps to ``max_pos - 1`` the same way
    (``lax.dynamic_slice_in_dim``).  The MoE family runs ``moe.moe_apply``
    whatever ``moe_mode``, as in JAX.  Only the VLM family passes
    ``local_window`` to the decode attention, as in JAX.

    The audio family's cross-attention reads ``cache["xk"]``/``cache["xv"]``,
    which nothing fills (neither here nor in JAX): its softmax over zero
    scores averages zero values, so each layer adds ``0 @ xwo``.  Under a
    ``tp=True`` policy it runs on the rank's block of them
    (``TensorParallel.cross_decode``).

    With a sharded ``act_specs`` (``forward``) ``params`` are the rank's blocks,
    ``tokens`` its rows and ``cache`` its ``init_cache``; the logits are the
    whole vocab's on every rank along ``model``.  The MoE runs ``_moe_view``'s
    decode rule, in groups of one token: ``moe.moe_apply_tp`` for experts split on
    d_ff, ``moe.moe_apply_gshard_tp`` for experts split on E (``moe_mode`` "ep" and
    "gshard"), ``moe.moe_apply`` on whole ones.
    """
    tp = tp_lib.context(cfg, act_specs)
    split_tp = None if tp is None else tp.model_view
    if tp is not None:
        tp.check(params)
    b = tokens.shape[0]
    hd = cfg.kq_head_dim
    h_, kv = cfg.n_heads, cfg.n_kv_heads
    pos = cache["len"]
    slot = min(pos, cache["k"].shape[2] - 1)
    if positions is None:
        shape = (3, b, 1) if cfg.rope_type == "mrope" else (b, 1)
        positions = torch.full(shape, pos, dtype=torch.int32, device=tokens.device)
    window = cfg.local_window if cfg.family == "vlm" else 0
    x = params["embed"][tokens.long()] if tp is None else tp.embed(params, tokens)
    if cfg.rope_type == "learned":
        pos_embed = (params["pos_embed"] if tp is None
                     else tp.whole(params["pos_embed"], "pos_embed"))
        x = x + pos_embed[min(pos, pos_embed.shape[0] - 1)]
    for i, lp in enumerate(L.unstack(params["layers"], cfg.n_layers)):
        if tp is not None:
            lp = tp.layer(lp, whole_experts=True)
        a = L.apply_norm(x, lp["attn_norm"], cfg.norm_type)
        if split_tp is None:
            q = (a @ lp["wq"]).reshape(b, 1, h_, hd)
            k = (a @ lp["wk"]).reshape(b, 1, kv, hd)
            v = (a @ lp["wv"]).reshape(b, 1, kv, hd)
            rows = positions
        else:
            q, k, v, rows = split_tp.heads(a @ lp["wq"], a @ lp["wk"], a @ lp["wv"], positions)
        q, k = _apply_pos(cfg, q, k, rows)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[:, slot:slot + 1] = k
        vc[:, slot:slot + 1] = v
        o = L.attention_decode(q, kc, vc, pos + 1, window=window)
        if split_tp is None:
            x = x + o.reshape(b, 1, h_ * hd) @ lp["wo"]
        else:
            x = x + split_tp.sum(split_tp.columns(o, b) @ lp["wo"])
        if cfg.enc_layers:
            xa = L.apply_norm(x, lp["xattn_norm"], cfg.norm_type)
            xk, xv = cache["xk"][i], cache["xv"][i]
            if split_tp is None:
                qx = (xa @ lp["xwq"]).reshape(b, 1, h_, hd)
                o = L.attention_decode(qx, xk, xv, cfg.enc_seq)
                x = x + o.reshape(b, 1, h_ * hd) @ lp["xwo"]
            else:
                x = x + split_tp.cross_decode(xa, lp["xwq"], lp["xwo"], xk, xv)
        m = L.apply_norm(x, lp["mlp_norm"], cfg.norm_type)
        if cfg.family == "moe" and tp is not None:
            y, _ = _moe_view(cfg, tp, lp["moe"], m, decode=True)
        elif cfg.family == "moe":
            y, _ = moe_lib.moe_apply(m, lp["moe"], cfg.top_k, cfg.capacity_factor)
        else:
            y = _mlp_block(cfg, lp, m, split_tp)
        x = x + y
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = x @ L.unembed(params) if tp is None else tp.logits(params, x, mask=False)
    cache["len"] = pos + 1
    return logits, cache


class DenseLM(nn.Module):
    """The stacked parameters as an ``nn.Module``; ``forward`` delegates to the function.

    ``state_dict()`` keys are the JAX pytree paths joined by dots
    (``layers.wq``, ``final_norm.scale``).
    """

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        _register(self, params)

    def params(self) -> dict:
        """The parameter tree the functions of this module take."""
        return _tree(self)

    def forward(self, tokens, positions=None, encoder_frames=None, use_kernel: bool = False):
        return forward(self.cfg, self.params(), tokens, positions, encoder_frames,
                       use_kernel=use_kernel)


def _register(module: nn.Module, tree: dict) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            child = nn.Module()
            _register(child, value)
            module.add_module(name, child)
        else:
            module.register_parameter(name, nn.Parameter(value, requires_grad=False))


def _tree(module: nn.Module) -> dict:
    out = dict(module.named_parameters(recurse=False))
    out.update({name: _tree(child) for name, child in module.named_children()})
    return out
