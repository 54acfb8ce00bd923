"""Tensor parallelism over ``model`` and FSDP over ``data`` in serving (dense family).

The JAX package has no counterpart module: it jits its prefill and decode steps
with ``in_shardings`` from ``param_specs`` (``repro/launch/dryrun.py``), and GSPMD
splits the compute.  Here each rank of a ``core.comm`` mesh runs the step on its
own blocks of the parameters, under ``sanitize_specs(param_specs(...))``, and
reaches the other ranks through its ``Comm``.  ``models/transformer.py`` takes
this path when ``act_specs`` holds the rank's ``Comm`` as ``"mesh"`` and a
``Policy`` with ``tp=True`` as ``"policy"``.  A layer runs as Megatron's:

* FSDP: a leaf whose spec splits a dimension over ``data`` is all-gathered
  along it when its layer runs (``Comm.all_gather``), one layer at a time, as
  ZeRO-3 does; over a ``data`` axis of 1 that is the block itself.
* the embedding, when its spec splits the vocab over ``model``: each rank looks
  up the tokens of its range, zero rows elsewhere, and the rows are summed over
  ``model`` (``Comm.psum``): adding zeros is exact, so this is the lookup's
  bits.  Where ``sanitize_specs`` left the vocab whole (an odd vocab) each rank
  looks up every token and nothing is summed.
* ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` column-parallel: the rank's
  columns are its block's.
* attention on whole heads.  The flat column split cuts heads (llama3.2-3b's
  192 columns of ``wq`` a rank of 16 are 1.5 heads), and RoPE rotates column
  i with column i + hd/2, so q, k and v move from the rank's columns to whole
  heads before RoPE and back after the attention, by a rule on shapes fixed
  before the step (``sharding.head_split``):
  - the pair route, where the rank's (B_local x KV) / n (row, kv head) pairs
    form a rectangle of rows x kv heads: one ``Comm.all_to_all`` of q, k and v
    together among the ``groups`` ranks whose columns make up the rank's kv
    heads (``axis_index_groups``), and one back for the output.  The flash
    kernel gets the rank's rows with its kv heads and their q heads;
  - the gather route elsewhere: q, k and v all-gathered together over
    ``model`` to every head, the attention of every head of the rank's rows on
    every rank (so ``model``-fold the attention work), and the rank's own
    columns kept.
* ``wo``, ``w_down`` row-parallel: the rank's rows, then a sum over ``model``
  built as a ring all-reduce is, from a reduce-scatter and an all-gather: the
  flat partial cut into ``model`` pieces, piece i to the i-th rank
  (``Comm.all_to_all``), each rank adding the pieces it got in group order,
  and the sums all-gathered.  That moves a ring all-reduce's bytes and gives
  the same bits on every transport (``Comm.psum`` adds in the transport's
  own order: NCCL's and gloo's all-reduce are not ``LocalMesh``'s).  Each
  rank's partial comes out of its matmul in the model's dtype; the sum runs
  in float32 and rounds to the model's dtype once, before the all-gather (in
  bfloat16 that is one rounding where a sum in bf16 would add 15 over 16
  ranks).
* the logits, vocab-parallel where the spec splits the vocab: the rank's
  columns of the last position only (the prefill step reads no other), the
  padded tail masked by global index in the prefill (not in decode, as in the
  reference), then all-gathered over ``model`` so that the greedy argmax sees
  the whole vocab with ``jnp.argmax``'s tie rule.

Decode keeps a cache of the rank's rows and kv heads only: under the pair route
(L, rows, S, kv_heads, hd), the bytes of ``cache_specs``' block, laid out by
(row, kv head) where ``cache_specs`` splits head_dim when the kv heads do not
divide ``model``; under the gather route (L, B_local, S, KV, hd), ``model``
times those bytes.

Serving only: ``Comm.all_gather`` has no backward, so a forward under autograd
raises (FSDP and TP in training are ROADMAP item 13); a family other than dense
given a ``tp=True`` policy raises too (ROADMAP item 14).
"""

from __future__ import annotations

import math
import threading

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import abstract_params
from repro_torch.configs.base import ArchConfig
from repro_torch.core.comm import Comm
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as shard_lib


def context(cfg: ArchConfig, act_specs) -> TensorParallel | None:
    """The rank's ``TensorParallel`` when ``act_specs`` asks for it (a ``"policy"``
    with ``tp=True`` and the rank's ``Comm`` as ``"mesh"``), else None."""
    act_specs = act_specs or {}
    policy = act_specs.get("policy")
    if policy is None or not policy.tp:
        return None
    if cfg.family != "dense":
        raise ValueError(f"{cfg.name}: tensor parallelism (a tp=True policy) is ported for "
                         f"the dense family only; the {cfg.family} family's is ROADMAP item 14")
    comm = act_specs.get("mesh")
    if not isinstance(comm, Comm):
        raise ValueError(f"{cfg.name}: a tp=True policy needs the rank's core.comm Comm as "
                         "act_specs['mesh'] (the step inside Mesh.run)")
    if policy.model_axis not in comm.mesh.shape:
        raise ValueError(f"{cfg.name}: the mesh {comm.mesh.axis_names} has no "
                         f"{policy.model_axis!r} axis")
    if cfg.act != "swiglu" or cfg.rope_type != "rope":
        raise ValueError(f"{cfg.name}: tensor parallelism takes the dense family's SwiGLU "
                         "and RoPE")
    return TensorParallel(cfg, comm, policy)


class _Leaf:
    """One leaf's part of a ``_Plan``: the block shape a rank holds, the
    (dimension, axes) pairs its FSDP all-gathers run over, and whether each
    dimension is split over ``model``."""

    def __init__(self, name, block, gathers, split):
        self.name, self.block, self.gathers, self.split = name, block, gathers, split


class _Plan:
    """What every rank of one (config, policy, mesh shape) needs, computed once:
    each leaf's ``_Leaf`` (the layer weights' without the layer axis), from the
    leaf's sanitized spec."""

    def __init__(self, cfg, policy, axes, shape):
        mesh = _Shape(dict(zip(axes, shape)))
        params = abstract_params(cfg)
        specs = shard_lib.sanitize_specs(params, shard_lib.param_specs(cfg, params, policy),
                                         mesh)
        self.model = policy.model_axis

        def leaf(name, meta, spec, lead=0):
            dims, gathers, split = [], [], []
            for dim, n in enumerate(meta.shape[lead:]):
                axes = _axes(spec[dim + lead] if dim + lead < len(spec) else None)
                parts = math.prod(mesh.shape[a] for a in axes)
                dims.append(n // parts)
                split.append(self.model in axes)
                other = tuple(a for a in axes if a != self.model)
                if other and len(other) != len(axes):
                    raise ValueError(f"{name}: {spec} splits a dimension over {self.model!r} "
                                     "and other axes, not a layout of param_specs")
                if other and math.prod(mesh.shape[a] for a in other) > 1:
                    gathers.append((dim, other))
            return _Leaf(name, tuple(dims), tuple(gathers), tuple(split))

        self.top = {k: leaf(k, params[k], specs[k]) for k in ("embed", "unembed")
                    if k in params}
        self.leaves = [leaf(n, m, sp) for n, m, sp in zip(
            _paths(params), tree_lib.leaves(params), tree_lib.leaves(specs), strict=True)]
        self.layer = _map2(lambda n, _, m, sp: leaf(n, m, sp, lead=1), params["layers"],
                           params["layers"], specs["layers"])
        for name, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("w_gate", 1), ("w_up", 1),
                          ("wo", 0), ("w_down", 0)):
            if not self.layer[name].split[dim]:
                raise ValueError(f"{cfg.name}: {name}'s spec leaves dimension {dim} whole over "
                                 f"{self.model!r} (it does not divide by {mesh.shape[self.model]})")


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
    """One rank's tensor-parallel view of ``cfg`` on its ``Comm``: its blocks'
    plan, and the collectives of the module docstring."""

    def __init__(self, cfg: ArchConfig, comm: Comm, policy: shard_lib.Policy):
        self.cfg, self.comm = cfg, comm
        self.plan = _plan(cfg, policy, comm.mesh)
        self.axis = policy.model_axis
        self.n = comm.axis_size(self.axis)
        self.index = comm.axis_index(self.axis)

    # -- blocks and FSDP ---------------------------------------------------

    def check(self, params) -> None:
        """Raise unless every leaf of ``params`` has the shape of the rank's block."""
        for leaf, t in zip(self.plan.leaves, tree_lib.leaves(params), strict=True):
            _check(self.cfg, leaf, t)

    def full(self, block: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
        """``block`` with every dimension that its spec splits over axes other than
        ``model`` all-gathered over them (FSDP)."""
        for dim, axes in leaf.gathers:
            parts = self.comm.all_gather(block, axes)  # (k, *block), in position order
            shape = list(block.shape)
            shape[dim] *= parts.shape[0]
            block = parts.movedim(0, dim).reshape(shape)
        return block

    def layer(self, lp: dict) -> dict:
        """One layer's weights (the per-layer trees ``layers.unstack`` gives) with
        FSDP undone, each leaf checked against its block."""
        return _map2(self._layer_leaf, lp, self.plan.layer, self.plan.layer)

    def _layer_leaf(self, name, t, leaf, _):
        _check(self.cfg, leaf, t)
        return self.full(t, leaf)

    # -- embedding and logits ----------------------------------------------

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel lookup of ``tokens``: (B, S, d), the same on every rank
        along ``model``."""
        leaf = self.plan.top["embed"]
        table = self.full(params["embed"], leaf)
        tokens = tokens.long()
        if not leaf.split[0]:
            return table[tokens]
        rows = table.shape[0]
        local = tokens - self.index * rows
        hit = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)]
        x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return self.comm.psum(x, self.axis)

    def logits(self, params, x: torch.Tensor, mask: bool) -> torch.Tensor:
        """Logits (B, 1, V) of the hidden states ``x`` (B, 1, d): the rank's vocab
        columns, the padded tail masked by global index when ``mask``, gathered
        over ``model``."""
        if "unembed" in params:
            leaf = self.plan.top["unembed"]
            w, split = self.full(params["unembed"], leaf), leaf.split[1]
        else:  # tied: the embedding's rows are the vocab
            leaf = self.plan.top["embed"]
            w, split = self.full(params["embed"], leaf).T, leaf.split[0]
        logits = x @ w
        width = logits.shape[-1]
        lo = self.index * width if split else 0
        if mask and width * (self.n if split else 1) != self.cfg.vocab:
            keep = torch.arange(lo, lo + width, device=logits.device) < self.cfg.vocab
            logits = torch.where(keep, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                                            device=logits.device))
        if not split:
            return logits
        parts = self.comm.all_gather(logits, self.axis)  # (n, B, 1, V/n)
        return parts.movedim(0, -2).reshape(*logits.shape[:-1], -1)

    # -- column and row products -------------------------------------------

    def sum(self, partial: torch.Tensor) -> torch.Tensor:
        """The row-parallel sum over ``model`` (module docstring): a reduce-scatter
        of the flat partial in float32 and group order, rounded to the partial's
        dtype once, then all-gathered."""
        # no local holds the pieces or the exchange's result past its use
        total = _ordered_sum(self.comm.all_to_all(_pieces(partial, self.n), self.axis))
        whole = self.comm.all_gather(total.to(partial.dtype), self.axis)
        return whole.reshape(-1)[:partial.numel()].reshape(partial.shape)

    def mlp(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU on the rank's columns of ``w_gate``/``w_up`` and rows of
        ``w_down``, summed over ``model``."""
        return self.sum(L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"]))

    # -- attention: the rank's columns <-> whole heads -------------------------

    def split(self, batch: int) -> shard_lib.HeadSplit | None:
        """The pair split of ``batch`` rows, or None for the gather route."""
        return shard_lib.head_split(batch, self.cfg.n_kv_heads, self.n)

    def heads(self, q, k, v, positions):
        """q, k, v of the rank's columns (B, S, cols) -> whole heads of the rank's
        share, (rows, S, heads, hd) each, and the rows' positions; the three move
        in one exchange."""
        b, s, _ = q.shape
        widths = [t.shape[-1] for t in (q, k, v)]
        qkv = torch.cat([q, k, v], -1)
        hs = self.split(b)
        if hs is None:  # gather: every head of every row
            got = self.comm.all_gather(qkv, self.axis)  # (n, B, S, cols)
        else:
            # entry r: the rows of row block r, to the group's r-th rank; entry m of
            # the result: the columns of the group's m-th rank, a part of the heads
            got = self.comm.all_to_all(qkv.reshape(hs.groups, hs.rows, s, -1), self.axis,
                                       hs.index_groups(self.n))
            r0 = (self.index % hs.groups) * hs.rows
            positions = positions[r0:r0 + hs.rows]
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
        got = self.comm.all_to_all(parts, self.axis, hs.index_groups(self.n))
        return got.reshape(hs.groups * rows, s, cols)

    # -- the decode cache --------------------------------------------------

    def cache_heads(self, batch: int) -> tuple[int, int]:
        """(rows, kv heads) of the rank's cache for a batch of ``batch`` rows."""
        hs = self.split(batch)
        return (batch, self.cfg.n_kv_heads) if hs is None else (hs.rows, hs.kv_heads)


def _pieces(partial: torch.Tensor, n: int) -> torch.Tensor:
    """``partial`` flat in float32 (or float64), zero-padded to ``n`` equal pieces:
    (n, -1)."""
    flat = partial.reshape(-1)
    if flat.dtype not in (torch.float32, torch.float64):
        flat = flat.float()
    if flat.numel() % n:
        flat = torch.nn.functional.pad(flat, (0, -flat.numel() % n))
    return flat.reshape(n, -1)


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum of ``parts`` (n, m) over its first axis, in that order."""
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


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
