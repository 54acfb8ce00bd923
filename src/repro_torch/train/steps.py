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

The serving steps run without autograd.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core import collectives as coll
from repro_torch.core import compression as comp
from repro_torch.models import get_model
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
    """
    model = get_model(cfg)
    tp_lib.context(cfg, act_specs)  # raises for a family without the path

    def loss_fn(params, batch):
        extras = model_extras(batch)
        if options.ce_chunk and cfg.family in ("dense", "moe", "vlm"):
            hidden, aux = model.forward(
                cfg, params, batch["tokens"], remat=options.remat,
                use_kernel=options.use_kernel, act_specs=act_specs, return_hidden=True,
                **extras,
            )
            unembed = params["unembed"] if "unembed" in params else params["embed"].T
            loss = chunked_cross_entropy(
                hidden, unembed, batch["labels"], cfg.vocab, options.ce_chunk)
        else:
            logits, aux = model.forward(
                cfg, params, batch["tokens"], remat=options.remat,
                use_kernel=options.use_kernel, act_specs=act_specs, **extras,
            )
            loss = cross_entropy(logits, batch["labels"])
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
    """
    if options.sync == "auto":
        grad_fn = value_and_grad(make_loss_fn(cfg, options, act_specs=act_specs))

        def train_step(params, opt_state, batch):
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
                                                   act_specs={**(act_specs or {}), "mesh": comm}))
        (_, (loss, aux)), grads = rank_grad_fn(params, batch)
        if options.compress_k:

            def sync_leaf(g):
                st = comp.init_state(g)  # stateless variant: residual dropped
                out, _ = comp.sparse_allreduce(comm, g.float(), st, options.compress_k,
                                               axes[0])
                # as the reference: sparse_allreduce already averaged over axes[0]
                return (out / dp_total).to(g.dtype)

            grads = tree_lib.tree_map(sync_leaf, grads)
        else:
            grads = coll.allreduce_tree(comm, grads, options.sync, axes,
                                        dp_shape if len(axes) > 1 else None, mean=True)
        loss = comm.psum(loss, axes) / dp_total
        aux = comm.psum(aux, axes) / dp_total
        return grads, loss, aux

    def train_step(params, opt_state, batch):
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

    Tensor parallelism (dense family): with ``act_specs["policy"]`` a ``Policy``
    with ``tp=True`` and ``act_specs["mesh"]`` the rank's ``Comm``, the step runs
    on one rank inside ``Mesh.run``: ``params`` its blocks under
    ``sanitize_specs(param_specs(...))`` (``sharding.rank_blocks``), ``batch``
    its rows under ``batch_specs``, and the logits are its rows', the whole
    vocab (``parallel/tensor_parallel.py``).  Another family raises.
    """
    model = get_model(cfg)
    tp_lib.context(cfg, act_specs)  # raises for a family without the path

    @torch.no_grad()
    def prefill_step(params, batch):
        extras = model_extras(batch)
        logits, _ = model.forward(
            cfg, params, batch["tokens"], remat=options.remat,
            use_kernel=options.use_kernel, act_specs=act_specs, **extras,
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
