"""Tensor parallelism over ``model`` and FSDP over ``data`` (every family).

The JAX package has no counterpart module: it jits its train, prefill and decode
steps with ``in_shardings`` from ``param_specs`` (``repro/launch/dryrun.py``),
and GSPMD splits the compute.  Here each rank of a ``core.comm`` mesh runs the
step on its own blocks of the parameters, under
``sanitize_specs(param_specs(...))``, and reaches the other ranks through its
``Comm``.  The model modules and ``train/steps.py`` take this path when
``act_specs`` holds the rank's ``Comm`` as ``"mesh"`` and a ``Policy`` as
``"policy"``.  A family's layers lie in stacks (``stacks``: the transformer's
``layers``, the hybrid's ``blocks.rec``, ``blocks.attn`` and ``tail``), each
leaf of a stack holding a layer on its leading axis.  Under a ``tp=True``
policy (every family) a layer runs as Megatron's:

* FSDP: a leaf whose spec splits a dimension over ``data`` is all-gathered
  along it when its layer runs (``Comm.all_gather``), one layer at a time, as
  ZeRO-3 does; over a ``data`` axis of 1 that is the block itself.
* the embedding, when its spec splits the vocab over ``model``: each rank looks
  up the tokens of its range, zero rows elsewhere, and the rows are summed over
  ``model`` (``Comm.psum``): adding zeros is exact, so this is the lookup's
  bits.  Where ``sanitize_specs`` left the vocab whole (an odd vocab) each rank
  looks up every token and nothing is summed.
* ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` column-parallel: the rank's
  columns are its block's.  The MoE experts are split on d_ff (P(None, None,
  fs, mp)), GSPMD's "operator parallelism": every rank routes and dispatches
  its replicated tokens alike, runs each expert on its F columns, combines its
  partial outputs and sums them over ``model`` (``models/moe.py:
  moe_apply_tp``): the row sum carries the (B, S, D) output, where XLA psums
  the (E, C, D) capacity buffer, top_k x capacity_factor times its bytes.
  Under ``moe_mode`` ``"ep"`` and ``"gshard"`` they are split on E
  (P(None, mp, fs, None), the router P(None, fs, None)): the rank holds E / n
  whole experts (``_Plan.experts_split``).  gshard routes every token, runs
  its experts on their buffers only and sums its part of y over ``model`` once
  (``moe.moe_apply_gshard_tp``); EP exchanges token slabs among the ranks
  along ``model`` (``moe.moe_apply_ep``, ``models/transformer.py:
  _moe_ep_view``), the tokens the same on every one of them in the 2d layout,
  so that each runs its experts on ``model`` identical copies of the slabs, as
  the reference's shard_map body does.  EP routes the whole batch as one
  dispatch group, as that body (manual over ``model`` alone) sees it: each
  rank keeps its rows, and one all-gather over the data axes of its pairs by
  expert and its router sums gives the group's capacity, slots and aux loss
  (``ep_axes``; under a sync mode the data axes are manual, as in JAX's step,
  and each data shard is a group).  Where E does not divide ``model``
  ``sanitize_specs`` leaves the experts whole: gshard runs every expert on
  every rank, nothing summed, and EP raises (``context``), as shard_map does.
  Under a ``tp=False`` policy the experts are whole at rest, and EP cuts the
  rank's E / n of them before the layer's FSDP gather (``layer``).
* attention on whole heads.  The flat column split cuts heads (llama3.2-3b's
  192 columns of ``wq`` a rank of 16 are 1.5 heads), and RoPE rotates column
  i with column i + hd/2, so q, k and v move from the rank's columns to whole
  heads before RoPE and back after the attention, by a rule on shapes fixed
  before the step (``sharding.head_split``):
  - the pair route, where the rank's (B_local x KV) / n (row, kv head) pairs
    form a rectangle of rows x kv heads: one ``Comm.all_to_all`` of q, k and v
    together among the ``groups`` ranks whose columns make up the rank's kv
    heads (``axis_index_groups``), and one back for the output.  The flash
    kernel gets the rank's rows with its kv heads and their q heads, and the
    rows' positions ((B, S), or M-RoPE's (3, B, S)) are cut along their row
    axis;
  - the gather route elsewhere: q, k and v all-gathered together over
    ``model`` to every head, the attention of every head of the rank's rows on
    every rank (so ``model``-fold the attention work), and the rank's own
    columns kept.
* the hybrid's recurrent layer (``models/recurrentgemma.py``): ``w_gate_in``
  and ``w_x_in`` column-parallel, giving the rank its Dr / n channels; the
  causal conv on them with the rank's channels of ``conv_w`` (the conv is
  channel-local); ``w_a`` and ``w_i`` contract over all of Dr, so the conv
  output is all-gathered over ``model`` (``all_columns``), as GSPMD does, and
  the rank takes its columns of the gates; the RG-LRU scan and the output gate
  on the rank's channels; ``w_out`` row-parallel.  ``lambda_p`` is whole under
  ``param_specs``, but each rank reads its channels of it only: it goes through
  ``pvary``, whose transpose sums the ranks' parts of its gradient over
  ``model`` (every other whole leaf, a norm scale, gets its whole gradient on
  every model rank);
* the SSM layer (``models/mamba2.py``): ``ssd_chunked`` is channel-local given
  its head's dt and A and the shared B and C, so a rank runs it on P / n of
  every head's channels, the split ``cache_specs`` gives the SSM state (its
  (B, H, P / n, N) block).  ``w_in`` (z | x | B | C | dt) may be whole or split
  over ``model`` (3352 = 2^3 x 419 columns), so it is read whole
  (``TensorParallel.read``: all-gathered over ``model`` where split, through
  ``pvary`` where whole), and the rank projects its z channels, its block of
  the conv channels (``conv_w``'s block, ``cache_specs``' conv state) and every
  head's dt; the conv output is all-gathered over ``model`` (``all_columns``)
  and the rank takes its x channels and the whole B and C; ``w_out``'s rows
  for its channels come from ``w_out`` read whole (on (1, 16) a rank's 96
  rows at rest are 1.5 heads), and the layer ends in the row sum.  ``A_log``,
  ``D`` and ``dt_bias`` are whole and read with the rank's channels: through
  ``pvary``;
* the audio family's gelu MLP (``TensorParallel.mlp``): ``w_up`` and the rank's
  columns of the whole ``b_up`` (through ``pvary``), gelu, ``w_down``, the row
  sum, then ``b_down`` once after it.  Its cross-attention runs on the whole
  ``x*`` weights (no rule of ``param_specs`` splits them) on every rank; in
  decode on the rank's block of the cross-attention cache (``cross_decode``);
* ``wo``, ``w_down``, ``w_out`` row-parallel: the rank's rows, then a sum over ``model``
  built as a ring all-reduce is: a ``Comm.reduce_scatter`` of the flat
  partial (an all-to-all and a sum in group order in float32), then an
  all-gather of the sums.  That moves a ring all-reduce's bytes and gives the
  same bits on every transport (``Comm.psum`` adds in the transport's own
  order: NCCL's and gloo's all-reduce are not ``LocalMesh``'s).  The sum
  rounds to the model's dtype once, before the all-gather (in bfloat16 that
  is one rounding where a sum in bf16 would add 15 over 16 ranks).
* the logits, vocab-parallel where the spec splits the vocab: in serving the
  rank's columns of the last position only (the prefill step reads no other),
  the padded tail masked by global index in the prefill (not in decode, as in
  the reference), then all-gathered over ``model`` so that the greedy argmax
  sees the whole vocab with ``jnp.argmax``'s tie rule.  In training no rank
  holds (B, S, V) logits: the cross-entropy is vocab-parallel (``loss_sum``): the
  row max all-gathered over ``model``, the exp-sums and the label's logit
  (from the rank whose columns hold it) ``psum``'d, the padded tail masked by
  global index; JAX's one-hot form gives GSPMD the same reductions.  With
  ``ce_chunk`` (``train/steps.py: _tp_loss``) the loss runs a sequence chunk
  of the rank's rows at a time, (rows, chunk, V / n) logits each, recomputed
  in the backward.

Decode keeps a cache of the rank's rows and kv heads only: under the pair route
(L, rows, S, kv_heads, hd), the bytes of ``cache_specs``' block, laid out by
(row, kv head) where ``cache_specs`` splits head_dim when the kv heads do not
divide ``model``; under the gather route (L, B_local, S, KV, hd), ``model``
times those bytes.  The audio family's cross-attention cache, the SSM state and
the conv states are ``cache_specs``' blocks.

Training.  Each exchange has the backward that matches how its output is used
(Megatron's *f* and *g*; a wrong one is off by a factor of ``model`` or
``data``):

* the FSDP all-gather over ``data``: the reduce-scatter of the gradient over
  ``data`` (each data rank applies the whole weight to its own rows);
* the normed input of the column products and of the vocab-parallel unembed:
  ``Comm.pvary`` over ``model``, the identity whose backward psums the ranks'
  parts of d(input);
* the row sum: the identity backward (``_RowSum``), as ``Comm.psum``'s: its
  output is replicated over ``model``, and the all-gather's transpose there
  would multiply the gradient by ``model``;
* EP's all-to-alls: the same exchange; where its tokens are the same on every
  rank along ``model``, its output's gradient divided by ``model``
  (``Comm.replicated_out``) and its slabs' tokens and gates through ``pvary``;
  its all-gather of the ranks' router sums over the data axes: the
  reduce-scatter (each rank's copy of the group's aux loss is seeded with
  1 / (the data axes' size), and the ranks' seeds add up);
* the pair route's all-to-alls: the same exchange (their own inverse); the
  gather route's all-gather over ``model``: the reduce-scatter over ``model``;
* the vocab-parallel embed's and the loss's psums: the gradient passes.

Each rank seeds its loss, its rows' mean, with 1 / (the data axes' size)
under ``sync="auto"`` (``train/steps.py``).  The leaves whole over a data axis
(the norm scales, a dimension ``sanitize_specs`` left whole) get their
gradients summed over it after the backward (``sum_over_data``), as GSPMD's
all-reduce does; not over ``model``: every model rank already holds their
whole gradient.  The gradient's global norm psums each leaf group's square sum
over the axes that split it (``global_norm``).

There are two routes to the gradient.  Under autograd the collectives above
are ``autograd.Function``s; that needs an autograd engine thread a rank: the
CPU, or one process a rank.  Rank threads that share one GPU share its one
engine thread, so ``train/steps.py: make_tp_value_and_grad`` keeps every
collective out of autograd: under a ``Tape`` each collective is a cut (its
input detached, its output a fresh leaf), and the tape carries each cut's
gradient across with the plain collective of its transpose.

Under a ``tp=False`` policy with FSDP (whisper-tiny's and mamba2-130m's
``default_policy``, every arch's ``layout="fsdp"``; the SSM family takes no
other) the rank's view splits
nothing over ``model``: each layer's FSDP leaves are all-gathered over ``data``
as it runs and the family's own layer code runs on the whole weights.  With
``data_axes=("data",)`` the ranks along ``model`` hold the same rows and compute
the same thing, as GSPMD's replicated compute does, and no gradient is summed
over ``model``; with ``layout="fsdp"`` (``data_axes=("data", "model")``)
``model`` is one more data axis: the batch is split over both, the parameters
over ``data`` only, and ``sum_over_data`` sums each leaf's gradient over the
data axes that leave it whole.  The audio family's encoder layers are gathered
the same way.
"""

from __future__ import annotations

import math
import threading

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import abstract_params
from repro_torch.configs.base import ArchConfig
from repro_torch.core import comm as comm_lib
from repro_torch.core.comm import Comm
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as shard_lib


def context(cfg: ArchConfig, act_specs) -> TensorParallel | None:
    """The rank's ``TensorParallel`` when ``act_specs`` asks for it (a ``"policy"``
    that splits, ``sharded``, and the rank's ``Comm`` as ``"mesh"``), else None."""
    act_specs = act_specs or {}
    policy = act_specs.get("policy")
    if policy is None or not sharded(cfg, policy):
        return None
    comm = act_specs.get("mesh")
    if not isinstance(comm, Comm):
        raise ValueError(f"{cfg.name}: a sharded policy needs the rank's core.comm Comm as "
                         "act_specs['mesh'] (the step inside Mesh.run)")
    if policy.model_axis not in comm.mesh.shape:
        raise ValueError(f"{cfg.name}: the mesh {comm.mesh.axis_names} has no "
                         f"{policy.model_axis!r} axis")
    n = comm.axis_size(policy.model_axis)
    if policy.tp and cfg.family == "ssm" and cfg.ssm_head_dim % n:
        raise ValueError(f"{cfg.name}: a rank runs the SSM on P / {n} channels of every head "
                         f"(cache_specs' split of the state), and P = {cfg.ssm_head_dim} does "
                         f"not divide by {n}")
    if cfg.family == "moe" and cfg.moe_mode == "ep" and cfg.n_experts % n:
        raise ValueError(f"{cfg.name}: moe_mode='ep' splits the {cfg.n_experts} experts over "
                         f"the {n} ranks of {policy.model_axis!r}, and {cfg.n_experts} does not "
                         f"divide by {n} (JAX's shard_map requires it too)")
    return TensorParallel(cfg, comm, policy, manual_data=bool(act_specs.get("manual_data")))


def sharded(cfg: ArchConfig, policy) -> bool:
    """Whether ``context`` gives a rank of ``cfg`` under ``policy`` a view: whether
    ``policy`` splits the parameters, over ``model`` (TP) or over ``data`` (FSDP).
    A policy that splits neither runs the whole model on a rank; every family
    takes either split."""
    return policy.tp or policy.fsdp


class _Leaf:
    """One leaf's part of a ``_Plan``: the block shape a rank holds, the
    (dimension, axes) pairs its FSDP all-gathers run over, whether each
    dimension is split over ``model``, and ``axes``: every mesh axis of more
    than one rank that splits the leaf, in the mesh's order."""

    def __init__(self, name, block, gathers, split, axes):
        self.name, self.block, self.gathers, self.split = name, block, gathers, split
        self.axes = axes
        self.expert = False  # an expert stack of a MoE layer that EP cuts on E (``_Plan``)


def stacks(cfg: ArchConfig) -> tuple[str, ...]:
    """The dotted paths of ``cfg``'s layer stacks: the subtrees whose every leaf
    holds one layer a row of its leading axis (a path the model does not have is
    left out)."""
    if cfg.family == "hybrid":
        return tuple(p for p in ("blocks.rec", "blocks.attn", "tail")
                     if p != "tail" or cfg.n_layers % max(1, cfg.attention_period))
    return ("layers", "encoder.layers") if cfg.enc_layers else ("layers",)


def _stacked(name: str, paths) -> bool:
    return any(name.startswith(p + ".") for p in paths)


# the products of a layer split over ``model`` under a tp=True policy, and the
# dimension of the layer's block split there: the column-parallel ones (and the
# hybrid's conv taps, on their channels) on 1, the row-parallel ones on 0 (the
# SSM layer reads its leaves whole or split alike: ``TensorParallel.read``)
_SPLIT_DIM = {**dict.fromkeys(("wq", "wk", "wv", "w_gate", "w_up", "w_gate_in", "w_x_in",
                               "w_a", "w_i", "conv_w"), 1),
              **dict.fromkeys(("wo", "w_down", "w_out"), 0)}


class _Plan:
    """What every rank of one (config, policy, mesh shape) needs, computed once:
    each leaf's ``_Leaf`` from its sanitized spec, in flatten order (``leaves``),
    and as a tree of ``params``' structure (``tree``) in which the leaves of a
    layer stack (``stacks``) are a layer's, without the layer axis."""

    def __init__(self, cfg, policy, axes, shape):
        mesh = _Shape(dict(zip(axes, shape)))
        params = abstract_params(cfg)
        specs = shard_lib.sanitize_specs(params, shard_lib.param_specs(cfg, params, policy),
                                         mesh)
        self.model = policy.model_axis if policy.tp else None

        def leaf(name, meta, spec, lead=0):
            dims, gathers, split, used = [], [], [], set()
            for dim, n in enumerate(meta.shape[lead:]):
                axes = _axes(spec[dim + lead] if dim + lead < len(spec) else None)
                parts = math.prod(mesh.shape[a] for a in axes)
                dims.append(n // parts)
                split.append(self.model in axes)
                used.update(axes)
                other = tuple(a for a in axes if a != self.model)
                if other and len(other) != len(axes):
                    raise ValueError(f"{name}: {spec} splits a dimension over {self.model!r} "
                                     "and other axes, not a layout of param_specs")
                if other and math.prod(mesh.shape[a] for a in other) > 1:
                    gathers.append((dim, other))
            split_by = tuple(a for a in mesh.shape if a in used and mesh.shape[a] > 1)
            return _Leaf(name, tuple(dims), tuple(gathers), tuple(split), split_by)

        metas, structure = tree_lib.flatten(params)
        paths = stacks(cfg)
        self.leaves = [leaf(n, m, sp) for n, m, sp in zip(
            _paths(params), metas, tree_lib.leaves(specs), strict=True)]
        self.tree = tree_lib.unflatten(structure, [
            leaf(n, m, sp, lead=int(_stacked(n, paths)))
            for n, m, sp in zip(_paths(params), metas, tree_lib.leaves(specs), strict=True)])
        self.layer = self.tree.get("layers")
        # the MoE's experts under moe_mode "ep" or "gshard": split on E over model
        # (P(None, mp, fs, None)) where E divides it under a tp=True policy, else
        # whole; EP takes the rank's E / n of whole ones as its layer is gathered
        moe = self.layer.get("moe") if self.layer else None
        self.experts_split = bool(moe) and moe["w_gate"].split[0]
        self.slice_experts = bool(moe) and cfg.moe_mode == "ep" and not self.experts_split
        if self.slice_experts:
            for name in ("w_gate", "w_up", "w_down"):
                moe[name].expert = True
        if policy.tp and cfg.family != "ssm":  # column and row products need their split
            want = []
            for path in paths:
                layer = self.stack(path)
                want += [(layer, n, d) for n, d in _SPLIT_DIM.items() if n in layer]
                if "moe" in layer and cfg.moe_mode == "tp":  # experts (E, D, F), (E, F, D): F
                    want += [(layer["moe"], n, d)
                             for n, d in (("w_gate", 2), ("w_up", 2), ("w_down", 1))]
            for tree, name, dim in want:
                if not tree[name].split[dim]:
                    raise ValueError(f"{cfg.name}: {tree[name].name}'s spec leaves dimension "
                                     f"{dim} whole over {self.model!r} (it does not divide by "
                                     f"{mesh.shape[self.model]})")

    def stack(self, path: str) -> dict:
        """The plan of one layer of the stack at the dotted ``path``."""
        return L.subtree(self.tree, path)


_PLANS: dict = {}
_PLANS_LOCK = threading.Lock()


def _plan(cfg: ArchConfig, policy: shard_lib.Policy, mesh) -> _Plan:
    """The plan of ``cfg`` under ``policy`` on ``mesh``'s shape: built by the first
    rank thread that asks, under the lock (one trace of ``abstract_params``),
    and shared."""
    axes = mesh.axis_names
    key = (cfg, policy, axes, tuple(mesh.shape[a] for a in axes))
    with _PLANS_LOCK:
        if key not in _PLANS:
            _PLANS[key] = _Plan(cfg, policy, *key[2:])
        return _PLANS[key]


class _Shape:
    """A mesh's ``shape`` alone, which ``sanitize_specs`` reads."""

    def __init__(self, shape):
        self.shape = shape


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


class TensorParallel:
    """One rank's sharded view of ``cfg`` on its ``Comm``: its blocks' plan, and
    the collectives of the module docstring.  ``tp`` says whether it splits over
    ``model`` (a ``tp=True`` policy); without, ``n`` is 1 and nothing is exchanged
    over ``model``.  While ``tape`` holds a ``Tape`` and autograd is on, every
    collective is a cut of that tape."""

    def __init__(self, cfg: ArchConfig, comm: Comm, policy: shard_lib.Policy,
                 manual_data: bool = False):
        self.cfg, self.comm, self.policy = cfg, comm, policy
        self.plan = _plan(cfg, policy, comm.mesh)
        self.tp = policy.tp
        self.axis = policy.model_axis
        self.n = comm.axis_size(self.axis) if self.tp else 1
        self.index = comm.axis_index(self.axis) if self.tp else 0
        # the model axis as EP's group, whatever the policy: the rank holds (or
        # cuts from whole stacks) experts [index·E/n, (index+1)·E/n)
        self.ep_n, self.ep_index = comm.axis_size(self.axis), comm.axis_index(self.axis)
        self.data_axes = tuple(policy.data_axes)
        missing = [a for a in self.data_axes if a not in comm.mesh.shape]
        if missing:
            raise ValueError(f"{cfg.name}: the mesh {comm.mesh.axis_names} has no data axes "
                             f"{missing}")
        # EP's dispatch group: the rows of every rank along these axes as one, as
        # JAX's shard_map body (manual over model alone) sees the whole batch;
        # none where the data axes are manual (``act_specs["manual_data"]``: a
        # sync mode's step, whose every data shard JAX routes on its own)
        self.ep_axes = () if manual_data else self.data_axes
        self.tape: Tape | None = None

    @property
    def model_view(self) -> TensorParallel | None:
        """This view where it splits over ``model`` (a ``tp=True`` policy), else
        None: what the column and row products of ``models/transformer.py`` take."""
        return self if self.tp else None

    # -- the collectives: plain, under autograd, or cuts of the tape ------------

    def _taped(self) -> bool:
        return self.tape is not None and torch.is_grad_enabled()

    def gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``Comm.all_gather``; its transpose is the reduce-scatter."""
        if self._taped():
            return self.tape.cut(x, lambda t: self.comm.all_gather(t, axes),
                                 lambda g: self.comm.reduce_scatter(g, axes))
        return self.comm.all_gather(x, axes)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``Comm.psum`` of a replicated output; the gradient passes."""
        if self._taped():
            return self.tape.cut(x, lambda t: self.comm.psum(t, axes), _identity)
        return self.comm.psum(x, axes)

    def pvary(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, replicated over ``model``, as the input of the rank's columns: the
        identity, whose transpose psums the ranks' parts of the gradient."""
        if self._taped():
            return self.tape.cut(x, _identity, lambda g: self.comm.psum(g, self.axis))
        return self.comm.pvary(x, self.axis)

    def exchange(self, x: torch.Tensor, index_groups) -> torch.Tensor:
        """``Comm.all_to_all`` over ``model``: its own transpose."""
        if self._taped():
            return self.tape.cut(
                x, lambda t: self.comm.all_to_all(t, self.axis, index_groups),
                lambda g: self.comm.all_to_all(g, self.axis, index_groups))
        return self.comm.all_to_all(x, self.axis, index_groups)

    # -- blocks and FSDP ---------------------------------------------------

    def check(self, params) -> None:
        """Raise unless every leaf of ``params`` has the shape of the rank's block."""
        for leaf, t in zip(self.plan.leaves, tree_lib.leaves(params), strict=True):
            _check(self.cfg, leaf, t)

    def full(self, block: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        """``block`` with every dimension that its spec splits over axes other than
        ``model`` all-gathered over them (FSDP)."""
        for dim, axes in leaf.gathers:
            parts = self.gather(block, axes)  # (k, *block), in position order
            shape = list(block.shape)
            shape[dim] *= parts.shape[0]
            block = parts.movedim(0, dim).reshape(shape)
        return block

    def layer(self, lp: dict, stack: str = "layers", whole_experts: bool = False) -> dict:
        """One layer's weights (the per-layer trees ``layers.unstack`` gives) of the
        stack at the dotted path ``stack`` (``stacks``) with FSDP undone, each leaf
        checked against its block.  Where EP runs on experts whole at rest
        (``_Plan.slice_experts``) the rank's E / n of them are cut before the
        gather, unless ``whole_experts`` (decode, which runs every expert)."""
        plan = self.plan.stack(stack)
        cut = self.plan.slice_experts and not whole_experts
        return _map2(lambda _, t, leaf, __: self._layer_leaf(t, leaf, cut), lp, plan, plan)

    def _layer_leaf(self, t, leaf, cut):
        _check(self.cfg, leaf, t)
        if cut and leaf.expert:
            el = t.shape[0] // self.ep_n
            t = t.narrow(0, self.ep_index * el, el)
        return self.full(t, leaf)

    def whole(self, t: torch.Tensor, *path: str) -> torch.Tensor:
        """The block ``t`` of the leaf at ``path`` (``"pos_embed"``, ``"encoder",
        "pos_embed"``) checked, with FSDP undone."""
        leaf = self.plan.tree
        for k in path:
            leaf = leaf[k]
        _check(self.cfg, leaf, t)
        return self.full(t, leaf)

    # -- embedding, logits and the loss ------------------------------------

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup of ``tokens``: (B, S, d), the same on every rank
        along ``model``."""
        leaf = self.plan.tree["embed"]
        table = self.full(params["embed"], leaf)
        tokens = tokens.long()
        if not leaf.split[0]:
            return table[tokens]
        rows = table.shape[0]
        local = tokens - self.index * rows
        hit = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.psum(x, self.axis)

    def _unembed(self, params) -> tuple[torch.Tensor, bool]:
        """The (d, columns) unembedding of the rank, FSDP undone, and whether its
        columns are a part of the vocab (split over ``model``)."""
        if "unembed" in params:
            leaf = self.plan.tree["unembed"]
            return self.full(params["unembed"], leaf), leaf.split[1]
        leaf = self.plan.tree["embed"]  # tied: the embedding's rows are the vocab
        return self.full(params["embed"], leaf).T, leaf.split[0]

    def _mask_tail(self, logits: torch.Tensor, split: bool) -> torch.Tensor:
        """The padded vocab's tail (global index >= vocab) at -1e30."""
        width = logits.shape[-1]
        if width * (self.n if split else 1) == self.cfg.vocab:
            return logits
        lo = self.index * width if split else 0
        keep = torch.arange(lo, lo + width, device=logits.device) < self.cfg.vocab
        return torch.where(keep, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                      device=logits.device))

    def logits(self, params, x: torch.Tensor, mask: bool) -> torch.Tensor:
        """Logits (B, 1, V) of the hidden states ``x`` (B, 1, d): the rank's vocab
        columns, the padded tail masked by global index when ``mask``, gathered
        over ``model``."""
        w, split = self._unembed(params)
        logits = x @ w
        if mask:
            logits = self._mask_tail(logits, split)
        return self.all_columns(logits) if split else logits

    def unembed_input(self, params, hidden: torch.Tensor):
        """(hidden, w, split) for ``loss_sum``: the final-norm hidden states (rows, S,
        d), through ``pvary`` where the rank's unembedding columns are a part of the
        vocab (``split``), and the rank's (d, columns) unembedding, FSDP undone."""
        w, split = self._unembed(params)
        return (self.pvary(hidden) if split else hidden), w, split

    def loss_sum(self, hidden: torch.Tensor, w: torch.Tensor, split: bool,
                 labels: torch.Tensor) -> torch.Tensor:
        """The cross-entropy summed over the tokens of ``hidden`` (rows, s, d)
        (float32), the same on every rank along ``model``: on the rank's vocab
        columns where ``split`` (the module docstring), else on every column.  A
        sequence chunk of ``unembed_input``'s output gives that chunk's sum."""
        logits = self._mask_tail(hidden @ w, split).float()
        labels = labels.long()
        if not split:
            lse = torch.logsumexp(logits, dim=-1)
            return torch.sum(lse - torch.gather(logits, -1, labels[..., None])[..., 0])
        width = logits.shape[-1]
        with torch.no_grad():  # the max only steadies the exponent
            top = self.comm.all_gather(logits.amax(-1), self.axis).amax(0)
        sums = self.psum(torch.sum(torch.exp(logits - top[..., None]), -1), self.axis)
        local = labels - self.index * width
        hit = (local >= 0) & (local < width)
        own = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[..., 0]
        label = self.psum(torch.where(hit, own, torch.zeros((), device=own.device)), self.axis)
        return torch.sum(top + torch.log(sums) - label)

    # -- column and row products -------------------------------------------

    def sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The row-parallel sum over ``model`` (module docstring): a reduce-scatter
        of the flat partial in float32 and group order, rounded to the partial's
        dtype once, then all-gathered; the gradient passes unchanged."""
        if self._taped():
            return self.tape.cut(partial, self._row_sum, _identity)
        if torch.is_grad_enabled() and partial.requires_grad:
            return _RowSum.apply(partial, self)
        return self._row_sum(partial)

    def _row_sum(self, partial: torch.Tensor) -> torch.Tensor:
        total = self.comm.reduce_scatter(comm_lib.pieces(partial, self.n), self.axis)
        whole = self.comm.all_gather(total.to(partial.dtype), self.axis)
        return whole.reshape(-1)[:partial.numel()].reshape(partial.shape)

    def all_columns(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's columns (..., c) of a tensor split on its last dimension over
        ``model`` -> every column (..., n·c), on every rank; the transpose
        reduce-scatters the gradient."""
        parts = self.gather(x, self.axis)  # (n, ..., c)
        return parts.movedim(0, -2).reshape(*x.shape[:-1], -1)

    def read(self, t: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        """A leaf's block ``t`` (FSDP undone) as the whole leaf, for a rank that
        reads a part of it of its own choosing: all-gathered over ``model`` along
        the dimension its spec splits there (the transpose reduce-scatters the
        ranks' parts of the gradient to the blocks), or where it is whole over
        ``model`` through ``pvary`` (the transpose psums them)."""
        if True not in leaf.split:
            return self.pvary(t)
        dim = leaf.split.index(True)
        parts = self.gather(t, self.axis)  # (n, *block)
        shape = list(t.shape)
        shape[dim] *= self.n
        return parts.movedim(0, dim).reshape(shape)

    def mlp(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        """The MLP on the rank's columns of ``w_gate``/``w_up`` and rows of
        ``w_down``, summed over ``model``: SwiGLU, or gelu with the rank's columns
        of ``b_up`` (whole, so through ``pvary``) and ``b_down`` added once, after
        the sum."""
        x = self.pvary(x)
        if "w_gate" in lp:
            return self.sum(L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]))
        c = lp["w_up"].shape[-1]
        b_up = self.pvary(lp["b_up"])[self.index * c:(self.index + 1) * c]
        h = torch.nn.functional.gelu(x @ lp["w_up"] + b_up, approximate="tanh")
        return self.sum(h @ lp["w_down"]) + lp["b_down"]

    # -- attention: the rank's columns <-> whole heads -------------------------

    def split(self, batch: int) -> shard_lib.HeadSplit | None:
        """The pair split of ``batch`` rows, or None for the gather route."""
        return shard_lib.head_split(batch, self.cfg.n_kv_heads, self.n)

    def heads(self, q, k, v, positions):
        """q, k, v of the rank's columns (B, S, cols) -> whole heads of the rank's
        share, (rows, S, heads, hd) each, and the rows' positions ((B, S), or
        M-RoPE's (3, B, S): rows on the second-last axis either way); the three
        move in one exchange."""
        b, s, _ = q.shape
        widths = [t.shape[-1] for t in (q, k, v)]
        qkv = torch.cat([q, k, v], -1)
        hs = self.split(b)
        if hs is None:  # gather: every head of every row
            got = self.gather(qkv, self.axis)  # (n, B, S, cols)
        else:
            # entry r: the rows of row block r, to the group's r-th rank; entry m of
            # the result: the columns of the group's m-th rank, a part of the heads
            got = self.exchange(qkv.reshape(hs.groups, hs.rows, s, -1), hs.index_groups(self.n))
            r0 = (self.index % hs.groups) * hs.rows
            positions = positions[..., r0:r0 + hs.rows, :]
        hd = self.cfg.kq_head_dim
        parts = torch.split(got, widths, -1)
        out = [t.permute(1, 2, 0, 3).reshape(t.shape[1], s, t.shape[0] * w // hd, hd)
               .contiguous() for t, w in zip(parts, widths)]  # the flash kernel's layout
        return (*out, positions)

    def columns(self, o: torch.Tensor, batch: int) -> torch.Tensor:
        """The attention output of the rank's share (rows, S, heads, hd) of a
        batch of ``batch`` rows -> the rank's columns (B, S, cols): the inverse
        of ``heads``."""
        rows, s, h, hd = o.shape
        cols = self.cfg.n_heads * hd // self.n
        hs = self.split(batch)
        if hs is None:  # gather: the rank's own columns of every head's output
            return o.reshape(rows, s, h * hd)[..., self.index * cols:(self.index + 1) * cols]
        parts = o.reshape(rows, s, hs.groups, cols).permute(2, 0, 1, 3).contiguous()
        got = self.exchange(parts, hs.index_groups(self.n))
        return got.reshape(hs.groups * rows, s, cols)

    # -- the decode cache --------------------------------------------------

    def cache_heads(self, batch: int) -> tuple[int, int]:
        """(rows, kv heads) of the rank's cache for a batch of ``batch`` rows."""
        hs = self.split(batch)
        return (batch, self.cfg.n_kv_heads) if hs is None else (hs.rows, hs.kv_heads)

    def cross_split(self) -> str | None:
        """How ``cache_specs`` splits the cross-attention cache (L, B, S, KV, hd)
        over ``model``: ``"heads"`` where the kv heads divide it, else
        ``"head_dim"`` where head_dim does, else None (whole)."""
        if self.cfg.n_kv_heads % self.n == 0:
            return "heads"
        return "head_dim" if self.cfg.kq_head_dim % self.n == 0 else None

    def cross_cache_shape(self, layers: int, batch: int) -> tuple[int, ...]:
        """The rank's block of the cross-attention cache for ``batch`` rows."""
        kv, hd = self.cfg.n_kv_heads, self.cfg.kq_head_dim
        split = self.cross_split()
        if split == "heads":
            kv //= self.n
        elif split == "head_dim":
            hd //= self.n
        return (layers, batch, self.cfg.enc_seq, kv, hd)

    def cross_decode(self, xa, wq, wo, k, v) -> torch.Tensor:
        """The decode step's cross-attention of the normed input ``xa`` (B, 1, d) on
        the rank's block ``k``, ``v`` of its cache (``cross_split``), with the whole
        ``xwq`` and ``xwo``: the rank's columns of q, the output's rows for them,
        summed over ``model``.  On a head_dim block the scores are psum'd over
        ``model`` before the softmax.  Every key of the cache counts, as in the
        unsharded step (``attention_decode`` at the encoder's length)."""
        b = xa.shape[0]
        h, kv, hd = self.cfg.n_heads, self.cfg.n_kv_heads, self.cfg.kq_head_dim
        split = self.cross_split()
        if split is None:
            o = L.attention_decode((xa @ wq).reshape(b, 1, h, hd), k, v, k.shape[1])
            return o.reshape(b, 1, h * hd) @ wo
        if split == "heads":
            hl = h // self.n
            cols = slice(self.index * hl * hd, (self.index + 1) * hl * hd)
            o = L.attention_decode((xa @ wq[:, cols]).reshape(b, 1, hl, hd), k, v, k.shape[1])
            return self.sum(o.reshape(b, 1, hl * hd) @ wo[cols])
        w = hd // self.n
        cols = (torch.arange(h, device=xa.device)[:, None] * hd + self.index * w
                + torch.arange(w, device=xa.device)).reshape(-1)
        q = (xa @ wq[:, cols]).reshape(b, 1, h, w)
        k, v = L._repeat_kv(k, h // kv), L._repeat_kv(v, h // kv)
        scores = torch.einsum("bqhd,bkhd->bhqk", q / math.sqrt(hd), k).float()
        probs = torch.softmax(self.psum(scores, self.axis), dim=-1).to(q.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.sum(o.reshape(b, 1, h * w) @ wo[cols])

    # -- gradients ---------------------------------------------------------

    def over_model(self, fn, grads):
        """``fn`` of each whole leaf, the rank's block of its result: each leaf's
        block all-gathered over ``model`` along the dimension its spec splits
        there, and ``fn``'s output cut back to the rank's part (a leaf's FSDP
        dimensions, if any, stay the rank's).  What a function of the whole
        gradient, top-k compression, needs of blocks."""
        leaves, structure = tree_lib.flatten(grads)
        out = []
        for leaf, g in zip(self.plan.leaves, leaves, strict=True):
            dim = leaf.split.index(True) if True in leaf.split else None
            if dim is None:
                out.append(fn(g))
                continue
            parts = self.comm.all_gather(g, self.axis)  # (n, *block)
            shape = list(g.shape)
            shape[dim] *= self.n
            full = fn(parts.movedim(0, dim).reshape(shape))
            out.append(full.narrow(dim, self.index * g.shape[dim], g.shape[dim]).contiguous())
        return tree_lib.unflatten(structure, out)

    def sum_over_data(self, grads):
        """``grads`` of the rank's blocks (a tree of ``params``' structure) with each
        leaf summed over the data axes that do not split it (GSPMD's all-reduce of
        a leaf whole over them); the others came out of their FSDP all-gathers'
        reduce-scatters summed already."""
        leaves, structure = tree_lib.flatten(grads)
        out = []
        for leaf, g in zip(self.plan.leaves, leaves, strict=True):
            axes = tuple(a for a in self.data_axes
                         if a not in leaf.axes and self.comm.axis_size(a) > 1)
            out.append(self.comm.psum(g, axes) if axes else g)
        return tree_lib.unflatten(structure, out)

    def global_norm(self, grads) -> torch.Tensor:
        """The whole gradient's norm from the rank's blocks of it: each group of
        leaves split by the same axes adds its squares and psums them over those
        axes (a replicated block counts once), and the groups are added in one
        order on every rank."""
        groups: dict = {}
        for leaf, g in zip(self.plan.leaves, tree_lib.leaves(grads), strict=True):
            sq = torch.sum(torch.square(g.float()))
            groups[leaf.axes] = sq if leaf.axes not in groups else groups[leaf.axes] + sq
        total = None
        for axes in sorted(groups):
            part = self.comm.psum(groups[axes], axes) if axes else groups[axes]
            total = part if total is None else total + part
        return torch.sqrt(total)


class Tape:
    """The cuts of one segment of the cut route (``train/steps.py:
    make_tp_value_and_grad``): each collective's input, its output (a fresh leaf
    that needs a gradient) and the plain collective of its transpose, in the
    order the forward ran them."""

    def __init__(self):
        self.cuts: list = []

    def cut(self, x: torch.Tensor, forward, transpose) -> torch.Tensor:
        """``forward(x)`` (a plain collective, outside autograd) as a new leaf."""
        with torch.no_grad():
            out = forward(x.detach()).detach().requires_grad_(True)
        self.cuts.append((x, out, transpose))
        return out

    def backward(self, y, grad) -> None:
        """Backpropagate ``grad`` from ``y`` (a tensor, or a list of tensors with a
        list of their gradients) into the leaves of its segment, then
        the cuts in the reverse order of the forward, a batch at a time: the
        last cut left, with each cut before it that no input of the batch
        reaches.  By then every use of a batch's outputs has added to their
        gradients, which the transposes carry to the cuts' inputs; one
        backward from those inputs follows, so that a graph two cuts share
        (the loss's logits) is traversed once, its gradients added where
        autograd adds them.  Every rank runs the same cuts in the same order,
        so the transposes' collectives match; the gradients add up in the
        leaves' ``.grad``."""
        roots, grads = (list(y), list(grad)) if isinstance(y, (list, tuple)) else ([y], [grad])
        while True:
            _backprop(roots, grads)
            if not self.cuts:
                return
            batch = [self.cuts.pop()]
            while self.cuts and not _reaches([x for x, _, _ in batch], self.cuts[-1][1]):
                batch.append(self.cuts.pop())
            roots, grads = [], []
            for x, out, transpose in batch:
                roots.append(x)
                grads.append(transpose(out.grad if out.grad is not None
                                       else torch.zeros_like(out)))


def _reaches(roots, leaf: torch.Tensor) -> bool:
    """Whether the graph behind any of ``roots`` has ``leaf`` among its leaves."""
    seen, stack = set(), [r.grad_fn for r in roots if r.grad_fn is not None]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if getattr(node, "variable", None) is leaf:
            return True
        stack.extend(fn for fn, _ in node.next_functions)
    return False


def _backprop(ys, grads) -> None:
    """Add the gradients ``grads`` of ``ys`` into the leaves behind them: a
    leaf's own ``.grad``, else through the graph, in one backward (kept:
    segments share parts of it)."""
    inner = []
    for y, g in zip(ys, grads, strict=True):
        if not y.requires_grad:
            continue
        if y.grad_fn is None:
            y.grad = g.clone() if y.grad is None else y.grad + g
        else:
            inner.append((y, g))
    if inner:
        torch.autograd.backward([y for y, _ in inner], [g for _, g in inner],
                                retain_graph=True)


def _identity(g: torch.Tensor) -> torch.Tensor:
    return g


class _RowSum(torch.autograd.Function):
    """``TensorParallel.sum`` under autograd: the exchange forward, the gradient
    unchanged backward (the output is replicated over ``model``)."""

    @staticmethod
    def forward(ctx, partial, tp):
        return tp._row_sum(partial)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _check(cfg, leaf: _Leaf, t: torch.Tensor) -> None:
    if tuple(t.shape) != leaf.block:
        raise ValueError(f"{cfg.name}: tensor parallelism takes the rank's blocks under "
                         f"sanitize_specs(param_specs); {leaf.name} is {tuple(t.shape)}, its "
                         f"block {leaf.block}")


def _paths(tree, prefix=""):
    """The leaves' dotted paths, in flatten order."""
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _paths(tree[k], f"{prefix}{k}.")
        else:
            out.append(prefix + k)
    return out


def _map2(fn, tree, metas, specs):
    """``fn(name, leaf, meta, spec)`` over the leaves of ``tree`` (dicts of
    tensors), with the matching entries of ``metas`` and ``specs``."""
    return {k: _map2(fn, v, metas[k], specs[k]) if isinstance(v, dict)
            else fn(k, v, metas[k], specs[k]) for k, v in tree.items()}
