"""Sharding rules: map param/batch/cache trees to partition specs (counterpart of ``repro.parallel.sharding``).

The production mesh is 2D ``("data", "model")`` per pod, with a leading
``"pod"`` axis in multi-pod runs (``launch/mesh.py``).  The rule tables are
the JAX package's, leaf by leaf, keyed on the same leaf names over the port's
trees, which have the same names and the same layer-stacked layout (DESIGN.md
§5):

* batch            → data axes (+pod)
* attention / mlp weights → Megatron column/row split on the flat feature dim
  over ``model`` + optional FSDP (ZeRO-3-style) over ``data``
* MoE expert weights → tensor split on d_ff over ``model`` (+FSDP); the
  expert-parallel modes shard the expert dim instead (``moe_apply_ep``)
* small archs (whisper-tiny, mamba2-130m) disable TP: params are replicated
  over ``model`` and FSDP keeps memory bounded.

The port keeps its own ``PartitionSpec``: one entry a leading dimension, each
an axis name, a tuple of names or None.  ``NamedSharding`` is the counterpart
of ``jax.sharding.NamedSharding`` plus ``jax.device_put``: over a
``core.comm`` mesh it cuts a global tensor into each rank's block and puts the
blocks back together, tiled as JAX tiles: an entry's axes split its dimension
row-major in the order given, and every axis the spec does not name
replicates.  This is not built on DTensor, which needs one process-group rank
a device, while ``LocalMesh`` ranks are threads of one process.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.core.comm import Comm


@dataclasses.dataclass(frozen=True)
class Policy:
    data_axes: tuple[str, ...] = ("data",)  # ("pod","data") in multi-pod
    model_axis: str = "model"
    fsdp: bool = True
    tp: bool = True

    @property
    def dp(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def fsdp_axis(self):
        return "data" if self.fsdp else None

    @property
    def mp(self):
        return self.model_axis if self.tp else None


class PartitionSpec:
    """``jax.sharding.PartitionSpec``: a sequence of entries, one a leading
    dimension.  Not a tuple, so that trees of specs flatten with each spec a
    leaf (``repro_torch.tree`` descends into tuples)."""

    def __init__(self, *parts):
        self._parts = tuple(parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self._parts == other._parts

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def _axes_of(entry) -> tuple[str, ...]:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


def _map_named(rule, tree):
    """``rule(name, leaf)`` over the leaves of a tree of dicts, ``name`` the
    leaf's own key (JAX: the last entry of the ``tree_map_with_path`` path)."""
    if isinstance(tree, dict):
        return {k: rule(k, v) if not isinstance(v, dict) else _map_named(rule, v)
                for k, v in tree.items()}
    return rule("", tree)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def default_policy(cfg: ArchConfig, multi_pod: bool = False, layout: str = "2d") -> Policy:
    """layout: '2d' = DP(+FSDP) x TP (the paper's D x O decomposition);
    'fsdp' = pure data parallelism over the whole mesh (1D rings)."""
    small = cfg.d_model < 1024  # whisper-tiny, mamba2-130m: DP-only
    if layout == "fsdp":
        return Policy(
            data_axes=(("pod", "data", "model") if multi_pod else ("data", "model")),
            fsdp=True,
            tp=False,
        )
    return Policy(data_axes=("pod", "data") if multi_pod else ("data",), fsdp=True,
                  tp=not small)


# ---------------------------------------------------------------------------
# parameter specs (rule table keyed on leaf names)
# ---------------------------------------------------------------------------


def param_specs(cfg: ArchConfig, params_shape, policy: Policy):
    """A spec tree matching ``params_shape`` (any tree whose leaves have ``.shape``:
    tensors, meta tensors)."""
    mp, fs = policy.mp, policy.fsdp_axis

    def rule(name, leaf):
        nd = len(_shape(leaf))
        if name == "embed":
            return P(mp, fs)
        if name == "unembed":
            return P(fs, mp)
        if name == "pos_embed":
            return P(None, fs)
        if name in ("scale", "bias", "lambda_p", "A_log", "D", "dt_bias", "b_up", "b_down"):
            return P(*([None] * nd))
        if name == "router":  # (L, D, E)
            return P(None, fs, None)
        if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_gate_in", "w_x_in", "w_in", "w_a",
                    "w_i"):
            if nd == 4:  # moe experts (L, E, D, F)
                if cfg.moe_mode in ("ep", "gshard"):  # experts over model
                    return P(None, mp, fs, None)
                return P(None, None, fs, mp)
            return P(None, fs, mp)  # (L, D, F)
        if name in ("wo", "w_down", "w_out"):
            if nd == 4:  # (L, E, F, D)
                if cfg.moe_mode in ("ep", "gshard"):
                    return P(None, mp, None, fs)
                return P(None, None, mp, fs)
            return P(None, mp, fs)
        if name == "conv_w":  # (L, W, C): shard channels
            return P(None, None, mp)
        return P(*([None] * nd))

    return _map_named(rule, params_shape)


def _dp_for(policy: Policy, mesh, batch: int):
    """The data axes for a batch dimension of ``batch``, or None where they do
    not divide it."""
    dp_total = math.prod(mesh.shape[ax] for ax in policy.data_axes)
    return policy.dp if batch % dp_total == 0 else None


def batch_axis(name: str) -> int:
    """The batch axis of batch leaf ``name``: the second of M-RoPE's (3, B, S)
    ``positions``, the first of every other leaf."""
    return 1 if name == "positions" else 0


def batch_specs(cfg: ArchConfig, policy: Policy, mesh, batch: int):
    dp = _dp_for(policy, mesh, batch)
    ndims = {"tokens": 2, "labels": 2}
    if cfg.rope_type == "mrope":
        ndims["positions"] = 3
    if cfg.enc_layers:
        ndims["encoder_frames"] = 3
    return {k: P(*(dp if i == batch_axis(k) else None for i in range(n)))
            for k, n in ndims.items()}


def cache_specs(cfg: ArchConfig, cache_shape, policy: Policy, mesh, batch: int):
    """KV-cache / recurrent-state specs: batch over data; heads or head_dim
    over model (whichever divides).  ``len`` (a Python int in the port's
    caches) is replicated."""
    mp_size = mesh.shape[policy.model_axis]
    mp = policy.model_axis  # shard states over model even for small archs
    dp = _dp_for(policy, mesh, batch)

    def rule(name, leaf):
        shape = _shape(leaf)
        if name == "len":
            return P()
        if name in ("k", "v", "xk", "xv"):  # (L, B, S, KV, hd)
            kv, hd = shape[3], shape[4]
            if kv % mp_size == 0:
                return P(None, dp, None, mp, None)
            if hd % mp_size == 0:
                return P(None, dp, None, None, mp)
            return P(None, dp, None, None, None)
        if name == "conv":  # (L, B, W, C)
            return P(None, dp, None, mp if shape[3] % mp_size == 0 else None)
        if name == "ssm":  # (L, B, H, P, N)
            return P(None, dp, None, mp if shape[3] % mp_size == 0 else None, None)
        if name == "lru":  # (L, B, Dr)
            return P(None, dp, mp if shape[2] % mp_size == 0 else None)
        return P(*([None] * len(shape)))

    return _map_named(rule, cache_shape)


def sanitize_specs(shapes, specs, mesh):
    """Drop sharding on dims the mesh axes don't divide evenly (e.g. odd
    vocabularies like minicpm's 122753): blocks must tile exactly."""

    def fix(leaf, spec):
        shape = _shape(leaf)
        return P(*(entry if entry is None
                   or shape[i] % math.prod(mesh.shape[a] for a in _axes_of(entry)) == 0
                   else None for i, entry in enumerate(spec)))

    leaves, structure = tree_lib.flatten(shapes)
    return tree_lib.unflatten(structure, [fix(leaf, s) for leaf, s in
                                          zip(leaves, tree_lib.leaves(specs), strict=True)])


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec over a ``core.comm`` mesh: where each rank's block of a global
    tensor lies, and the moves between the two (``put``, ``Sharded.gather``)."""

    mesh: object
    spec: PartitionSpec

    def block(self, rank: int, shape) -> tuple[slice, ...]:
        """The slices of a global tensor of ``shape`` that ``rank`` holds."""
        out = []
        for i, n in enumerate(shape):
            axes = _axes_of(self.spec[i]) if i < len(self.spec) else ()
            parts = self.mesh.axis_size(axes) if axes else 1
            if n % parts:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not split into "
                                 f"{parts} blocks over {axes} ({self.spec})")
            size = n // parts
            pos = self.mesh.axis_index(rank, axes) if axes else 0
            out.append(slice(pos * size, (pos + 1) * size))
        return tuple(out)

    def put(self, x: torch.Tensor) -> Sharded:
        """``jax.device_put(x, self)``: the block of ``x`` of each rank this process
        holds (every rank of a ``LocalMesh``, its own of a ``DistMesh``), a copy on
        that rank's device."""
        blocks: list = [None] * self.mesh.size
        rank = getattr(self.mesh, "rank", None)  # a DistMesh's own rank
        for r in range(self.mesh.size) if rank is None else [rank]:
            blocks[r] = x[self.block(r, x.shape)].to(self.mesh.device(r), copy=True,
                                                     memory_format=torch.contiguous_format)
        return Sharded(self, tuple(x.shape), x.dtype, blocks)


@dataclasses.dataclass(eq=False)
class Sharded:
    """A global tensor held as blocks, ``blocks[r]`` rank r's (None for a rank of
    another process): the counterpart of a ``jax.Array`` with a ``NamedSharding``.
    ``blocks`` is what ``Mesh.run`` hands out, one entry a rank."""

    sharding: NamedSharding
    shape: tuple[int, ...]
    dtype: torch.dtype
    blocks: list

    def gather(self) -> torch.Tensor:
        """The global tensor on the host, put back together from the blocks.  On a
        ``DistMesh`` it is a collective: every process calls it, and the blocks
        come over ``all_gather``."""
        sh, mesh = self.sharding, self.sharding.mesh
        blocks = self.blocks
        if any(b is None for b in blocks):  # every rank's block, in rank order
            comm = Comm(mesh, mesh.rank)
            blocks = list(comm.all_gather(blocks[mesh.rank], mesh.axis_names).unbind(0))
        out = torch.empty(self.shape, dtype=self.dtype)
        seen = set()
        for r, b in enumerate(blocks):
            sl = sh.block(r, self.shape)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in seen:  # replicas hold the same block
                seen.add(key)
                out[sl] = b.cpu()
        return out


def rank_blocks(sharded, rank: int):
    """Rank ``rank``'s blocks of a tree of ``Sharded`` (``shard_tree``'s output): the
    tree a rank's tensor-parallel step takes (``parallel/tensor_parallel.py``)."""
    return tree_lib.tree_map(lambda s: s.blocks[rank], sharded)


def block_views(tree, specs, mesh, rank: int):
    """Views of rank ``rank``'s blocks of the global tensors of ``tree`` under
    ``specs`` (meta tensors too): what ``rank_blocks`` holds, without copies."""
    leaves, structure = tree_lib.flatten(tree)
    return tree_lib.unflatten(structure, [
        x[NamedSharding(mesh, s).block(rank, x.shape)]
        for x, s in zip(leaves, tree_lib.leaves(specs), strict=True)])


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """A rank's share of the attention under tensor parallelism: ``rows`` rows of
    the batch by ``kv_heads`` kv heads (with their GQA groups of q heads).  The
    ``model`` positions hold the kv blocks in turn, ``groups`` consecutive
    positions each (``groups`` = the batch's row blocks): position i takes kv
    block ``i // groups`` and row block ``i % groups``."""

    rows: int
    kv_heads: int
    groups: int

    def index_groups(self, n: int):
        """The ``axis_index_groups`` of the exchange between the rank's columns
        and its heads: the ``groups`` positions that share a kv block (None
        when one group holds every position)."""
        if self.groups == n:
            return None
        return tuple(tuple(range(k, k + self.groups)) for k in range(0, n, self.groups))


def head_split(batch: int, n_kv: int, n: int) -> HeadSplit | None:
    """The pair split of ``batch`` rows x ``n_kv`` kv heads over ``n`` ranks along
    ``model``, or None (the gather route): the split needs ``batch * n_kv / n``
    (row, kv head) pairs a rank, laid out as a rectangle of rows x kv heads that
    tiles the batch and the heads.  Of the rectangles, the one with the most kv
    heads (and so the fewest rows) is taken."""
    pairs, rem = divmod(batch * n_kv, n)
    if rem or not pairs:
        return None
    for kv in range(min(pairs, n_kv), 0, -1):
        rows, r = divmod(pairs, kv)
        if not r and n_kv % kv == 0 and batch % rows == 0:
            return HeadSplit(rows, kv, batch // rows)
    return None


def to_shardings(mesh, specs):
    """A ``NamedSharding`` over ``mesh`` for every spec of the tree."""
    return tree_lib.tree_map(lambda s: NamedSharding(mesh, s), specs)


def shard_tree(tree, shardings):
    """``jax.device_put(tree, shardings)``: every leaf as a ``Sharded``."""
    leaves, structure = tree_lib.flatten(tree)
    return tree_lib.unflatten(structure, [s.put(x) for x, s in
                                          zip(leaves, tree_lib.leaves(shardings), strict=True)])


def activation_specs(cfg: ArchConfig, policy: Policy, mesh, batch: int):
    """NamedShardings for activation anchors (batch over dp, vocab over mp).

    Vocab sharding is only applied when it divides the model axis evenly.  The
    port's ``forward`` reads no anchor but ``"mesh"`` (the rank's ``Comm`` for
    ``moe_mode="ep"``): the anchors name layouts, which change no number."""
    dp = _dp_for(policy, mesh, batch)
    mp = policy.mp
    if mp and cfg.vocab % mesh.shape[policy.model_axis] != 0:
        mp = None
    specs = {
        "act": NamedSharding(mesh, P(dp, None, None)),
        "logits": NamedSharding(mesh, P(dp, None, mp)),
    }
    if cfg.family == "moe" and cfg.moe_mode == "gshard" and policy.mp:
        # (G, E, C, D) capacity buffers: groups over data, experts over model
        specs["experts"] = NamedSharding(mesh, P(dp, policy.mp, None, None))
    return specs
