"""Train and serving steps (counterpart of ``repro.train.steps``).

Gradient synchronization modes (the paper's technique as a first-class
feature):

* ``sync="auto"``: one process computes the loss and its gradient on the
  whole batch with autograd and applies AdamW (the JAX package's baseline,
  where XLA inserts its own gradient all-reduce).  ``compress_k`` is not
  read, as in JAX.
* ``sync in {"ring","bidir","torus","hamiltonian"}``: the paper's HxMesh
  collective algorithms (``core/collectives.py``) over a mesh of ranks
  (``core/comm.py``).  Each rank takes its shard of the batch along the
  policy's data axes, computes its gradient, and the gradients are reduced
  with neighbour-only ppermute rings over those axes, as the JAX version's
  full-manual ``shard_map`` does.
* ``compress_k > 0`` with a sync mode: top-k sparsified gradient sync (paper
  Appendix A) over the first data axis, in the reference's stateless form.

The sharded path (every family; ``parallel/tensor_parallel.py``): with the
rank's ``Comm`` as
``act_specs["mesh"]`` and a ``Policy`` as ``act_specs["policy"]`` the train
step runs on one rank inside ``Mesh.run``, on its blocks of the parameters and
moments and its rows of the batch, as JAX's step jitted with ``in_shardings``
from ``param_specs`` runs under GSPMD: ``sync="auto"`` splits the compute over
``model`` (a ``tp=True`` policy) and the parameters, gradients and moments over
``data`` (FSDP); a sync mode is JAX's partial-manual step, the blocks split
over ``model`` and whole over the data axes, the gradients reduced over them by
the paper's algorithm.  Its gradient route, ``make_tp_value_and_grad``, keeps
every collective out of autograd.

The serving steps run without autograd.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch import trace
from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as coll
from repro_torch.core import comm as comm_lib
from repro_torch.core import compression as comp
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import sharding as shard_lib
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.train import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    sync: str = "auto"  # auto | ring | bidir | torus | hamiltonian
    remat: bool = True
    use_kernel: bool = False
    compress_k: int = 0
    moe_aux_weight: float = 0.01
    # sequence-chunked CE: compute unembed+loss in S-chunks so the full
    # (tokens, vocab) logits are never materialized (0 = off).
    ce_chunk: int = 0


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean of logsumexp minus the label's logit, in float32.

    The JAX version contracts a one-hot of the labels with the logits, so a
    vocab-sharded layout stays sharded; the sum has one nonzero term, so a
    gather of the label's logit gives the same number without a (B, S, V)
    one-hot.
    """
    return torch.mean(_token_losses(logits.float(), labels))


def _token_losses(logits, labels):
    """logsumexp minus the label's logit, per token."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse - torch.gather(logits, -1, labels.long()[..., None])[..., 0]


# the model inputs a batch may carry beside the tokens: the VLM's (3, B, S)
# positions, the audio family's encoder frames
MODEL_EXTRAS = ("positions", "encoder_frames")


def model_extras(batch) -> dict:
    """The entries of ``batch`` that ``forward`` takes beside the tokens."""
    return {k: batch[k] for k in MODEL_EXTRAS if k in batch}


def make_loss_fn(cfg: ArchConfig, options: TrainOptions, act_specs=None):
    """loss_fn(params, batch) -> (loss + moe_aux_weight·aux, (loss, aux)).

    ``act_specs`` goes to the model's ``forward``: its layout anchors change no
    number, and its ``"mesh"``, the rank's ``Comm``, carries the MoE family's
    ``moe_mode="ep"`` (``models/transformer.py::forward``).

    On the sharded path (``act_specs``' policy) ``params`` are the rank's
    blocks and ``batch`` its rows; the loss is the vocab-parallel cross-entropy
    (``TensorParallel.loss_sum``): under ``sync="auto"`` the whole batch's mean,
    psum'd over the data axes from each rank's share (its rows' mean / their
    size: the seed of 1/dp), under a sync mode the rank's rows' mean.  The MoE
    aux loss is the mean over the rank's dispatch groups, under ``sync="auto"``
    psum'd over the data axes the same way (every data rank holds as many
    groups), as JAX averages it over every group; EP's one group of the whole
    batch gives every rank the same aux, which that mean leaves as it is.
    With ``ce_chunk`` the loss runs a sequence chunk at a time (``_tp_loss``).
    Every collective is differentiable: the autograd route, one autograd engine
    thread a rank (the CPU, one process a rank).
    """
    model = get_model(cfg)
    tp = tp_lib.context(cfg, act_specs)  # raises for a family without the path
    if tp is not None:

        def tp_loss_fn(params, batch):
            hidden, aux = model.forward(cfg, params, batch["tokens"], remat=options.remat,
                                        use_kernel=options.use_kernel, act_specs=act_specs,
                                        return_hidden=True, **model_extras(batch))
            loss = _tp_loss(tp, options, params, hidden, batch["labels"])
            aux = _tp_aux(tp, options, aux)
            return loss + options.moe_aux_weight * aux, (loss, aux)

        return tp_loss_fn

    def loss_fn(params, batch):
        extras = model_extras(batch)
        if _ce_chunk(cfg, options):
            hidden, aux = model.forward(
                cfg, params, batch["tokens"], remat=options.remat,
                use_kernel=options.use_kernel, act_specs=act_specs, return_hidden=True,
                **extras,
            )
            unembed = params["unembed"] if "unembed" in params else params["embed"].T
            with trace.span("loss") as sp:
                loss = sp.outputs(chunked_cross_entropy(
                    sp.inputs(hidden), unembed, batch["labels"], cfg.vocab, options.ce_chunk))
        else:
            logits, aux = model.forward(
                cfg, params, batch["tokens"], remat=options.remat,
                use_kernel=options.use_kernel, act_specs=act_specs, **extras,
            )
            with trace.span("loss") as sp:
                loss = sp.outputs(cross_entropy(sp.inputs(logits), batch["labels"]))
        return loss + options.moe_aux_weight * aux, (loss, aux)

    return loss_fn


def _chunk_loss_sum(h, unembed, labels, vocab: int):
    logits = (h @ unembed).float()
    if logits.shape[-1] != vocab:
        keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(keep, logits, torch.tensor(-1e30, device=logits.device))
    return torch.sum(_token_losses(logits, labels))


def chunked_cross_entropy(hidden, unembed, labels, vocab: int, chunk: int):
    """CE without materializing the full (tokens, V) logits.

    Each sequence chunk computes its own unembed product and loss sum; under
    autograd a chunk runs again in the backward pass
    (``torch.utils.checkpoint``, as the JAX version's ``jax.checkpoint``
    around its scan body), so only one chunk's logits are alive at a time.
    The last chunk is shorter when ``chunk`` does not divide S, where the JAX
    version pads and masks.
    """
    b, s, _ = hidden.shape
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h, lab = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = torch.utils.checkpoint.checkpoint(
                _chunk_loss_sum, h, unembed, lab, vocab, use_reentrant=False)
        else:
            part = _chunk_loss_sum(h, unembed, lab, vocab)
        total = total + part
    return total / (b * s)


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a tree of tensors.

    Returns f(params, batch) -> ((value, aux), grads), the gradient of the
    value with respect to every leaf of ``params`` (a tree of the same
    structure).  The caller's tensors are not changed: the loss sees detached
    views of them that require grad.
    """

    def f(params, batch):
        flat, spec = tree_lib.flatten(params)
        views = [p.detach().requires_grad_(True) for p in flat]
        value, aux = loss_fn(tree_lib.unflatten(spec, views), batch)
        grads = torch.autograd.grad(value, views, allow_unused=True, materialize_grads=True)
        aux = tree_lib.tree_map(lambda t: t.detach(), aux)
        return (value.detach(), aux), tree_lib.unflatten(spec, list(grads))

    return f


def _ce_chunk(cfg: ArchConfig, options: TrainOptions) -> int:
    """The sequence chunk of the cross-entropy, or 0 for the whole sequence: JAX
    reads ``ce_chunk`` for the dense, MoE and VLM families only."""
    return options.ce_chunk if cfg.family in ("dense", "moe", "vlm") else 0


def _chunks(s: int, chunk: int) -> list[tuple[int, int]]:
    """The [start, end) spans of S in chunks of ``chunk`` (S itself where 0): the
    last one shorter where ``chunk`` does not divide S, where JAX pads it and
    masks the padding out of the sum, the same terms."""
    step = chunk or s
    return [(c0, min(c0 + step, s)) for c0 in range(0, s, step)]


def _loss_share(tp, options: TrainOptions) -> int:
    """What the rank's loss is divided by before its psum over the data axes:
    their size under ``sync="auto"``, else 1 (no psum)."""
    dp = tp.comm.axis_size(tp.data_axes)
    return dp if options.sync == "auto" and dp > 1 else 1


def _tp_share(tp, options: TrainOptions, loss):
    """The whole batch's loss from the rank's rows' mean: psum'd over the data axes
    from its share under ``sync="auto"``; the rank's own under a sync mode."""
    share = _loss_share(tp, options)
    return tp.psum(loss / share, tp.data_axes) if share > 1 else loss


def _tp_loss(tp, options: TrainOptions, params, hidden, labels):
    """The rank's loss: its rows' mean cross-entropy, vocab-parallel
    (``TensorParallel.loss_sum``), summed a sequence chunk at a time with
    ``ce_chunk`` (``chunked_cross_entropy``'s sum on the rank's vocab columns:
    each chunk's logits (rows, chunk, V / n), its log-sum-exp and label logit
    reduced over ``model``; every column where the vocab does not divide
    ``model``), under autograd each chunk run again in the backward
    (``torch.utils.checkpoint``, as JAX's scan body's ``jax.checkpoint``); under
    ``sync="auto"`` psum'd over the data axes from its share of the mean."""
    hidden, w, split = tp.unembed_input(params, hidden)
    chunk = _ce_chunk(tp.cfg, options)
    remat = chunk and torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a, b in _chunks(hidden.shape[1], chunk):
        args = (hidden[:, a:b], w, split, labels[:, a:b])
        part = (torch.utils.checkpoint.checkpoint(tp.loss_sum, *args, use_reentrant=False)
                if remat else tp.loss_sum(*args))
        total = total + part
    return _tp_share(tp, options, total / labels.numel())


def _tp_chunked_loss_cut(tp, options: TrainOptions, params, hidden, labels):
    """``_tp_loss`` with ``ce_chunk`` on the cut route (``make_tp_value_and_grad``,
    under its tape): the sum of every chunk under ``no_grad``, then each chunk
    recomputed under a tape of its own and its gradient carried back at once,
    seeded with d(loss) / d(sum) = 1 / (tokens · share), so that no rank holds
    more than one chunk's (rows, chunk, V / n) logits or their gradient.  The
    chunks' gradients add up in the outputs of the caller tape's cuts (the
    unembedding's FSDP gather, the hidden states' ``pvary``), whose transposes
    run in that tape's backward, after."""
    hidden, w, split = tp.unembed_input(params, hidden)
    spans = _chunks(hidden.shape[1], _ce_chunk(tp.cfg, options))
    with torch.no_grad():
        total = sum(tp.loss_sum(hidden[:, a:b], w, split, labels[:, a:b]) for a, b in spans)
    seed = 1.0 / (labels.numel() * _loss_share(tp, options))
    outer = tp.tape
    try:
        for a, b in spans:
            tp.tape = tp_lib.Tape()
            part = tp.loss_sum(hidden[:, a:b], w, split, labels[:, a:b])
            tp.tape.backward(part, torch.full_like(part, seed))
            del part
    finally:
        tp.tape = outer
    return _tp_share(tp, options, total / labels.numel())


def _aux_share(tp, options: TrainOptions) -> int:
    """What the rank's MoE aux loss is divided by before its psum over the data
    axes, as the loss is (``_loss_share``); 1 (no psum) for the other families."""
    return _loss_share(tp, options) if tp.cfg.family == "moe" else 1


def _tp_aux(tp, options: TrainOptions, aux):
    """The MoE aux loss of the whole batch from the rank's (``make_loss_fn``)."""
    share = _aux_share(tp, options)
    return tp.psum(aux / share, tp.data_axes) if share > 1 else aux


def make_tp_value_and_grad(cfg: ArchConfig, options: TrainOptions, act_specs):
    """``value_and_grad(make_loss_fn(cfg, options, act_specs))`` on the sharded
    path, with no collective inside autograd: the route for rank threads that
    share one GPU (whose backwards would queue on its one autograd engine
    thread, and wait there for ranks queued behind them), and the one the train
    step takes on every mesh, so that the CPU checks the code the card runs.

    Returns f(params, batch) -> ((value, (loss, aux)), grads): ``params`` the
    rank's blocks, ``batch`` its rows (with the VLM's positions and the audio
    family's encoder frames), ``grads`` the value's gradient with respect to
    each block (a tree of the same structure), which is ``value_and_grad``'s
    on the autograd route.  The layers are the family's ``layer_sequence``
    ((stack, index, layer) in forward order: the transformer's and mamba2's
    ``layers``, the hybrid's blocks of recurrent and attention layers, then its
    tail).  The steps (``parallel/pipeline.py: make_pipelined_value_and_grad``'s,
    inside a layer):

    1. the encoder's layers (audio), the embed and the layers of the sequence
       forward under ``no_grad``, keeping each layer's input (what remat keeps)
       and summing the layers' MoE aux losses;
    2. the final norm and the loss under a ``Tape``, then its backward: the
       graph from the loss to its leaves, then each cut in reverse, its
       output's gradient carried to its input by the plain collective of its
       transpose (``Tape.backward``);
    3. the layers in reverse, each recomputed under the tape from its input,
       with the gradient of its output and, for the MoE, of its aux loss
       (``moe_aux_weight / n_layers``, over the data axes' size where the aux
       is psum'd over them), so that the router gets the aux's gradient; the
       encoder's output is one leaf that every layer's cross-attention reads,
       so its gradient adds up over the layers;
    4. the encoder's final norm and layers in reverse the same way, from the
       encoder output's gradient, then the encoder's input;
    5. the embed recomputed the same way, with the gradient of the first
       layer's input (so that no rank keeps its FSDP-gathered table through
       the layers).

    With ``LocalMesh``'s turns only one rank's local backward is queued on the
    device's engine thread at a time.  A layer's weights are leaves of their own
    (views of the blocks), whose gradients are copied into each stack's.
    """
    act_specs = act_specs or {}
    if act_specs.get("policy") is None or not isinstance(act_specs.get("mesh"), comm_lib.Comm):
        raise ValueError(f"{cfg.name}: make_tp_value_and_grad needs the rank's Comm and a "
                         "sharded policy in act_specs")
    tp = tp_lib.context(cfg, act_specs)
    loss_fn = _tp_chunked_loss_cut if _ce_chunk(cfg, options) else _tp_loss
    aux_seed = options.moe_aux_weight / cfg.n_layers / _aux_share(tp, options)
    seq = get_model(cfg).layer_sequence(cfg)
    paths = list(dict.fromkeys(stack for stack, _, _ in seq))

    def layer_grads_into(dst, lp, i):
        for d, leaf in zip(tree_lib.leaves(dst), tree_lib.leaves(lp), strict=True):
            if leaf.grad is not None:
                d[i].copy_(leaf.grad)

    def f(params, batch):
        tp.check(params)
        tokens, labels = batch["tokens"], batch["labels"]
        extras = model_extras(batch)
        positions = extras.get("positions")
        if positions is None:
            positions = T.default_positions(cfg, tokens)
        stacks = {p: L.subtree(params, p) for p in paths}
        rest = _without(params, paths)
        enc_stacks = None
        if "encoder" in rest:
            enc_stacks = rest["encoder"]["layers"]
            rest["encoder"] = {k: v for k, v in rest["encoder"].items() if k != "layers"}
        top = tree_lib.tree_map(_grad_leaf, rest)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        tape = tp_lib.Tape()
        try:
            inputs, enc_inputs, enc = [], [], None
            with torch.no_grad():
                if enc_stacks is not None:
                    e = T.encoder_embed(cfg, top["encoder"], extras["encoder_frames"], tp)
                    for lp in L.unstack(enc_stacks, cfg.enc_layers):
                        enc_inputs.append(e)
                        e = T.encoder_layer(cfg, lp, e, tp)
                    enc_inputs.append(e)  # the final norm's input
                    enc = L.apply_norm(e, top["encoder"]["final_norm"], cfg.norm_type)
                x = T.embed(cfg, top, tokens, tp)
                unstacked = {p: L.unstack(t, L.depth(t)) for p, t in stacks.items()}
                for stack, i, layer in seq:
                    inputs.append(x)
                    x, aux = layer(cfg, unstacked[stack][i], x, aux, positions, enc,
                                   use_kernel=options.use_kernel, tp=tp)
                del unstacked
                aux = _tp_aux(tp, options, aux / cfg.n_layers)
            tp.tape = tape
            with torch.enable_grad():
                h = x.requires_grad_(True)
                loss = loss_fn(tp, options, top, L.apply_norm(h, top["final_norm"],
                                                              cfg.norm_type), labels)
                value = loss + options.moe_aux_weight * aux
            tape.backward(value, torch.ones_like(value))
            # the loss's graph goes now, not with ``f``'s locals after the layers
            grad, value, loss = h.grad, value.detach(), loss.detach()
            del h
            if enc is not None:
                enc.requires_grad_(True)
            layer_grads = {p: tree_lib.tree_map(torch.zeros_like, t) for p, t in stacks.items()}
            zero = torch.zeros_like(aux)
            for j in reversed(range(len(seq))):
                stack, i, layer = seq[j]
                lp = tree_lib.tree_map(lambda t, i=i: _grad_leaf(t[i]), stacks[stack])
                with torch.enable_grad():
                    x_in = inputs[j].requires_grad_(True)
                    y, a_loss = layer(cfg, lp, x_in, zero, positions, enc,
                                      use_kernel=options.use_kernel, tp=tp)
                if cfg.family == "moe":
                    tape.backward([y, a_loss], [grad, torch.full_like(a_loss, aux_seed)])
                else:
                    tape.backward(y, grad)
                grad, inputs[j] = x_in.grad, None
                layer_grads_into(layer_grads[stack], lp, i)
                del y, a_loss, lp, x_in
            enc_grads = None
            if enc is not None:
                with torch.enable_grad():
                    e_in = enc_inputs[-1].requires_grad_(True)
                    e_out = L.apply_norm(e_in, top["encoder"]["final_norm"], cfg.norm_type)
                tape.backward(e_out, enc.grad)
                g, enc = e_in.grad, None
                enc_grads = tree_lib.tree_map(torch.zeros_like, enc_stacks)
                for i in reversed(range(cfg.enc_layers)):
                    lp = tree_lib.tree_map(lambda t, i=i: _grad_leaf(t[i]), enc_stacks)
                    with torch.enable_grad():
                        e_in = enc_inputs[i].requires_grad_(True)
                        e_out = T.encoder_layer(cfg, lp, e_in, tp)
                    tape.backward(e_out, g)
                    g, enc_inputs[i] = e_in.grad, None
                    layer_grads_into(enc_grads, lp, i)
                    del e_out, lp, e_in
                with torch.enable_grad():
                    e0 = T.encoder_embed(cfg, top["encoder"], extras["encoder_frames"], tp)
                tape.backward(e0, g)
                del e0, g
            with torch.enable_grad():
                x0 = T.embed(cfg, top, tokens, tp)
            tape.backward(x0, grad)
        finally:
            tp.tape = None
        grads = tree_lib.tree_map(
            lambda t: torch.zeros_like(t) if t.grad is None else t.grad, top)
        for p, g in layer_grads.items():
            _put(grads, p, g)
        if enc_grads is not None:
            grads["encoder"]["layers"] = enc_grads
        return (value, (loss, aux)), grads

    return f


def _without(tree: dict, paths) -> dict:
    """A copy of the nested dict ``tree`` (its leaves shared) without the subtrees
    at the dotted ``paths``; a dict left empty goes too."""
    out = {}
    for k, v in tree.items():
        inner = [p[len(k) + 1:] for p in paths if p.startswith(k + ".")]
        if k in paths:
            continue
        if inner and isinstance(v, dict):
            v = _without(v, inner)
            if not v:
                continue
        out[k] = v
    return out


def _put(tree: dict, path: str, value) -> None:
    """``tree`` at the dotted ``path`` set to ``value`` (dicts made on the way)."""
    *parents, last = path.split(".")
    for k in parents:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _grad_leaf(t: torch.Tensor) -> torch.Tensor:
    """A leaf that needs a gradient, sharing ``t``'s storage."""
    return t.detach().requires_grad_(True)


def _sync_grads(comm, grads, loss, aux, options: TrainOptions, axes, dp_shape, tp=None):
    """The gradients, loss and aux of one data shard reduced over the data
    ``axes``: the paper's allreduce (mean) or top-k compression, as the JAX
    version's partial-manual step does.  With ``tp`` the gradients are the
    rank's blocks, and top-k takes each whole leaf's k largest, as JAX's step
    (``model`` auto) sees the leaf (``TensorParallel.over_model``)."""
    dp_total = comm.axis_size(axes)
    if options.compress_k:

        def sync_leaf(g):
            st = comp.init_state(g)  # stateless variant: residual dropped
            out, _ = comp.sparse_allreduce(comm, g.float(), st, options.compress_k, axes[0])
            # as the reference: sparse_allreduce already averaged over axes[0]
            return (out / dp_total).to(g.dtype)

        grads = (tree_lib.tree_map(sync_leaf, grads) if tp is None
                 else tp.over_model(sync_leaf, grads))
    else:
        grads = coll.allreduce_tree(comm, grads, options.sync, axes,
                                    dp_shape if len(axes) > 1 else None, mean=True)
    loss = comm.psum(loss, axes) / dp_total
    aux = comm.psum(aux, axes) / dp_total
    return grads, loss, aux


def _step_specs(options: TrainOptions, act_specs):
    """``act_specs`` with the policy of the train step's blocks: under a sync mode
    the data axes are manual, so the blocks are whole over them (``fsdp=False``;
    a ``tp=False`` policy then splits nothing and takes the plain sync step), and
    each data shard is EP's dispatch group (``"manual_data"``)."""
    policy = (act_specs or {}).get("policy")
    if policy is None or options.sync == "auto":
        return act_specs
    return {**act_specs, "policy": dataclasses.replace(policy, fsdp=False),
            "manual_data": True}


def _make_tp_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig, options: TrainOptions,
                        act_specs):
    """``make_train_step`` on the sharded path (its docstring): ``act_specs`` holds
    the policy of the step's blocks (``_step_specs``)."""
    tp = tp_lib.context(cfg, act_specs)
    comm, axes = tp.comm, tp.data_axes
    if (options.sync in ("torus", "hamiltonian") and not options.compress_k
            and len(axes) != 2):
        raise ValueError(f"sync={options.sync!r} needs two data axes, got {axes}")
    dp_shape = tuple(comm.mesh.shape[a] for a in axes)
    grad_fn = make_tp_value_and_grad(cfg, options, act_specs)

    def train_step(params, opt_state, batch):
        (_, (loss, aux)), grads = grad_fn(params, batch)
        if options.sync == "auto":
            grads = tp.sum_over_data(grads)
        else:
            grads, loss, aux = _sync_grads(comm, grads, loss, aux, options, axes, dp_shape, tp)
        params, opt_state, m = opt.apply(ocfg, opt_state, params, grads,
                                         norm_fn=tp.global_norm)
        return params, opt_state, {"loss": loss, "aux": aux, **m}

    return train_step


def make_train_step(cfg: ArchConfig, ocfg: opt.AdamWConfig, options: TrainOptions,
                    policy=None, mesh=None, act_specs=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    With ``sync="auto"`` the step reads neither ``policy`` nor ``mesh``, as in
    JAX.  A sync mode needs both: a ``parallel.sharding.Policy`` whose
    ``data_axes`` name axes of ``mesh`` (a ``core.comm.Mesh``).  Ranks along
    an axis that is not a data axis take the same shard and do the same work.
    The step updates ``params`` and the moments in place (``optimizer.apply``),
    once, with the synced gradients, and returns them.  ``act_specs`` goes to
    ``make_loss_fn``.

    The sharded path (every family; ``tensor_parallel.context``): with
    ``act_specs["policy"]`` a ``Policy`` and ``act_specs["mesh"]`` the rank's
    ``Comm``, the step runs on one rank inside ``Mesh.run`` and reads neither
    ``policy`` nor ``mesh``:
    ``params`` are its blocks (``sharding.rank_blocks``), ``opt_state``
    ``optimizer.init`` of them, ``batch`` its rows under ``batch_specs``.
    Under ``sync="auto"`` the blocks are those of ``act_specs``' policy (FSDP
    over ``data``); under a sync mode those of the policy with ``fsdp=False``
    (split over ``model`` under ``tp=True``, whole over the data axes, JAX's
    ``in_specs=P()`` over its manual data axes), their gradients reduced over
    the data axes by the mode's algorithm (mean).  The gradients come from
    ``make_tp_value_and_grad``; the leaves whole over a data axis are summed
    over it (``TensorParallel.sum_over_data``), and the clipping norm is the
    whole gradient's (``TensorParallel.global_norm``).  ``grad_norm`` and the
    loss are the same on every rank.  What the path does not hold raises
    (``tensor_parallel.context``).
    """
    step_specs = _step_specs(options, act_specs)
    if tp_lib.context(cfg, step_specs) is not None:
        return _make_tp_train_step(cfg, ocfg, options, step_specs)
    if options.sync == "auto":
        grad_fn = value_and_grad(make_loss_fn(cfg, options, act_specs=act_specs))

        def train_step(params, opt_state, batch):
            with trace.span("train_step"):
                (_, (loss, aux)), grads = grad_fn(params, batch)
                params, opt_state, m = opt.apply(ocfg, opt_state, params, grads)
                return params, opt_state, {"loss": loss, "aux": aux, **m}

        return train_step

    # --- paper-collective mode: one rank a mesh position ------------------
    if mesh is None or policy is None:
        raise ValueError(f"sync={options.sync!r} needs a mesh and a policy")
    axes = tuple(policy.data_axes)
    dp_shape = tuple(mesh.shape[a] for a in axes)
    dp_total = mesh.axis_size(axes)

    def synced_grads(comm, params, batch):
        """Runs on one rank with its data shard; the forward gets the rank's
        ``Comm`` as ``act_specs["mesh"]`` (read by ``moe_mode="ep"``)."""
        params = tree_lib.tree_map(lambda t: t.to(comm.device), params)
        batch = {k: v.to(comm.device) for k, v in batch.items()}
        rank_grad_fn = value_and_grad(make_loss_fn(cfg, options,
                                                   act_specs={**(step_specs or {}), "mesh": comm}))
        (_, (loss, aux)), grads = rank_grad_fn(params, batch)
        return _sync_grads(comm, grads, loss, aux, options, axes, dp_shape)

    def train_step(params, opt_state, batch):
        with trace.span("train_step"):
            shards = [_data_shard(batch, mesh.axis_index(r, axes), dp_total)
                      for r in range(mesh.size)]
            grads, loss, aux = mesh.run(synced_grads, [params] * mesh.size, shards)[0]
            flat, spec = tree_lib.flatten(params)
            grads = tree_lib.unflatten(spec, [g.to(p.device) for g, p in
                                              zip(tree_lib.leaves(grads), flat)])
            params, opt_state, m = opt.apply(ocfg, opt_state, params, grads)
            return params, opt_state, {"loss": loss, "aux": aux, **m}

    return train_step


def _data_shard(batch, index: int, n: int):
    """Shard ``index`` of ``n`` of every batch leaf along its batch axis, as
    ``batch_specs`` shards them."""
    out = {}
    for k, v in batch.items():
        dim = shard_lib.batch_axis(k)
        if v.shape[dim] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[dim]} rows for {n} data shards")
        rows = v.shape[dim] // n
        out[k] = v.narrow(dim, index * rows, rows)
    return out


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, options: TrainOptions, act_specs=None):
    """prefill_step(params, batch) -> logits of the last position, (B, 1, V).
    ``act_specs`` goes to the model's ``forward``, as in ``make_loss_fn``.

    The sharded path: with ``act_specs["policy"]`` a ``Policy`` and
    ``act_specs["mesh"]`` the rank's ``Comm``, the step runs on one rank inside
    ``Mesh.run``: ``params`` its blocks under ``sanitize_specs(param_specs(...))``
    (``sharding.rank_blocks``), ``batch`` its rows under ``batch_specs``, and the
    logits are its rows', the whole vocab (``parallel/tensor_parallel.py``).
    What the path does not hold raises.
    """
    model = get_model(cfg)
    tp_lib.context(cfg, act_specs)  # raises for a family without the path

    @torch.no_grad()
    def prefill_step(params, batch):
        with trace.span("prefill"):
            logits, _ = model.forward(
                cfg, params, batch["tokens"], remat=options.remat,
                use_kernel=options.use_kernel, act_specs=act_specs, **model_extras(batch),
            )
            return logits[:, -1:]

    return prefill_step


def make_decode_step(cfg: ArchConfig, act_specs=None):
    """serve_step(params, cache, tokens (B, 1)) -> (next tokens (B, 1) int32, cache).

    ``act_specs`` is read for tensor parallelism only, as ``make_prefill_step``
    reads it: then ``cache`` is the rank's (``init_cache`` with the same
    ``act_specs``), and every rank along ``model`` returns the same tokens."""
    model = get_model(cfg)
    extra = {"act_specs": act_specs} if tp_lib.context(cfg, act_specs) is not None else {}

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(cfg, params, cache, tokens, **extra)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return serve_step
