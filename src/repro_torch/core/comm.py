"""Meshes of ranks: the port's stand-in for ``shard_map`` and its collectives.

The JAX package writes the paper's allreduce algorithms once, per device,
inside ``shard_map``, and reaches the other devices through
``lax.axis_index``, ``lax.ppermute``, ``lax.psum``, ``lax.all_gather`` and
``lax.all_to_all`` over named mesh axes.  Here a ``Mesh`` has the same named axes and shape,
and ``Mesh.run(fn, *per_rank_args)`` calls ``fn(comm, *args)`` once per rank,
as ``shard_map`` calls its body once per device.  ``comm`` is that rank's
``Comm``: its coordinates and the five primitives, with JAX's semantics:

* ``ppermute(x, axes, perm)``: ``perm`` pairs positions along ``axes`` (one
  axis, or several linearised in the order given); every other coordinate
  is held fixed, so the pairs expand to global (src, dst) ranks as JAX
  expands a ppermute over named axes.  A rank that no pair sends to gets
  zeros.  Its backward is JAX's transpose: the ppermute of the gradient
  with every pair reversed (a rank that no reversed pair sends to gets
  zeros).
* ``psum(x, axes)`` and ``all_gather(x, axes)`` (a new leading axis, in the
  order of the positions along ``axes``) over the ranks that share every
  other coordinate.  ``psum``'s output is the same on every rank of the
  group, and its backward passes that one value's gradient to each rank's
  input unchanged: the gradient JAX gives ``jax.grad`` of a ``shard_map``
  whose output is a psum (``out_specs=P()``), and not the group's sum of it.
  ``all_gather``'s backward is JAX's transpose: the ``reduce_scatter`` of
  the gradient.
* ``reduce_scatter(x, axes)``: ``lax.psum_scatter(x, axes,
  scatter_dimension=0, tiled=False)``.  ``x`` has one leading entry a rank of
  the group; the group's i-th rank gets the sum of every rank's entry i,
  added in group order in float32 (float64 stays float64) and rounded to
  ``x``'s dtype once.  It is built on every transport as an all-to-all and
  that ordered sum, so ``LocalMesh``, gloo and NCCL give the same bits, and
  each rank sends a ring reduce-scatter's bytes, (g - 1)/g of ``x``.  Its
  backward is JAX's transpose: the ``all_gather`` of the gradient.
* ``all_to_all(x, axes, axis_index_groups=None)``: ``lax.all_to_all(x, axes,
  0, 0, tiled=False, axis_index_groups=...)`` over the same ranks, or over
  the ranks of this rank's index group (positions along ``axes``; the groups
  partition them, all of one size).  ``x`` has one leading entry a rank of
  the group; entry i goes to the group's i-th rank, and entry j of the
  result is what its j-th rank sent to this one.  Its backward is the same
  exchange of the gradient, since with the split and concat axes both 0 the
  exchange is its own inverse.
* ``pvary(x, axes)`` and ``replicated_out(x, axes)`` move nothing forward;
  they give a ``shard_map`` body's boundary JAX's gradients (see each).

A collective's backward runs only under autograd, on a tensor that needs a
gradient; every rank of the group must then run its backward too.  Under
``no_grad``, or on a tensor that needs none, each primitive is the plain
exchange.  Training through a collective needs one autograd engine thread a
rank: it works on the CPU (each calling thread runs its own backward) and
one process a rank, but not for rank threads that share one GPU, whose
backwards all queue on that device's one engine thread
(``parallel/pipeline.py`` keeps collectives out of autograd for that case).

Ranks are numbered row-major over the mesh shape (the last axis fastest),
as ``jax.make_mesh`` lays devices out.  Two transports carry the data:

* ``LocalMesh``: the ranks are threads of one process, each with its own
  ``torch.device`` (all on one GPU, one per GPU, or the CPU).  A transfer is
  a copy of the sender's tensor onto the receiver's device after a barrier;
  a psum is added up once a group, by its first rank, in group order, and
  copied to the others after a second barrier.
* ``DistMesh``: one rank per process of a ``torch.distributed`` process
  group (gloo on CPU tensors, NCCL on GPUs); ppermute is
  ``batch_isend_irecv`` between global ranks, psum ``all_reduce``,
  all_gather ``all_gather_into_tensor`` and all_to_all ``all_to_all_single``.

A third, ``TraceMesh``, moves nothing: it runs the ranks it is asked for in
the calling thread, and its collectives return placeholders of the right
shape, dtype and device with no peer.  The dry-run (``launch/dryrun.py``)
traces one rank of the production mesh through it on fake tensors.

Each counts what it moves in ``Mesh.stats``: ppermute, all_to_all and
reduce_scatter bytes and messages by (src, dst) rank pair, and psum,
all_gather, all_to_all and reduce_scatter calls.
"""

from __future__ import annotations

import math
import threading
from collections import Counter
from collections.abc import Sequence

import torch

Axes = str | tuple[str, ...]


def _as_tuple(axes: Axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class CommStats:
    """What a mesh's transport moved since the last ``reset``.

    ``bytes`` and ``messages`` count ppermute sends (those of its backward
    too), and the entries an all_to_all or a reduce_scatter sends to other
    ranks, by (src, dst) global rank pair;
    ``psum_calls``, ``all_gather_calls``, ``all_to_all_calls`` and
    ``reduce_scatter_calls`` count one per rank and call (a backward that runs
    a collective is a call of that collective's kind), and ``payload`` the
    bytes of those calls' inputs by kind.  A ``DistMesh`` counts the sends
    and calls of its own rank only.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.bytes: Counter = Counter()
            self.messages: Counter = Counter()
            self.psum_calls = 0
            self.all_gather_calls = 0
            self.all_to_all_calls = 0
            self.reduce_scatter_calls = 0
            self.payload: Counter = Counter()

    def record_send(self, src: int, dst: int, nbytes: int) -> None:
        with self._lock:
            self.bytes[(src, dst)] += nbytes
            self.messages[(src, dst)] += 1

    def record_call(self, kind: str, nbytes: int = 0) -> None:
        """One call of ``kind`` ("psum", "all_gather", "all_to_all" or
        "reduce_scatter") on an input of ``nbytes``."""
        with self._lock:
            setattr(self, f"{kind}_calls", getattr(self, f"{kind}_calls") + 1)
            self.payload[kind] += nbytes


class Mesh:
    """Named axes over ``size`` ranks; a transport subclass moves the data."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
        if min(shape, default=0) < 1:
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))  # as jax.sharding.Mesh.shape
        self.size = math.prod(shape)
        self.stats = CommStats()
        self._peers: dict = {}
        self._peers_lock = threading.Lock()
        self._groups: dict = {}  # group()'s answers, by (rank, axes, index_groups)

    # -- layout ------------------------------------------------------------

    def coords(self, rank: int) -> dict[str, int]:
        """The rank's position along every axis (row-major, last axis fastest)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: dict[str, int]) -> int:
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords[name]
        return rank

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _as_tuple(axes))

    def axis_index(self, rank: int, axes: Axes) -> int:
        """The rank's position along ``axes``, linearised in the order given."""
        c = self.coords(rank)
        idx = 0
        for a in _as_tuple(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, rank: int, axes: Axes, index_groups=None) -> list[int]:
        """The ranks that share every coordinate of ``rank`` off ``axes``, in the
        order of their position along ``axes``; with ``index_groups`` (JAX's
        ``axis_index_groups``: a partition of those positions) only the ranks of
        the part that holds ``rank``'s position, in that part's order."""
        axes = _as_tuple(axes)
        key = (rank, axes, index_groups)
        members = self._groups.get(key)
        if members is None:
            members = self._group(rank, axes, index_groups)
            with self._peers_lock:
                self._groups[key] = members
        return list(members)

    def _group(self, rank, axes, index_groups):
        self._check_axes(axes)
        base = self.coords(rank)
        members = []
        for pos in range(self.axis_size(axes)):
            c = dict(base)
            for a in reversed(axes):
                pos, c[a] = divmod(pos, self.shape[a])
            members.append(self.rank_of(c))
        if index_groups is None:
            return members
        self._check_index_groups(axes, index_groups)
        pos = self.axis_index(rank, axes)
        return [members[i] for i in next(g for g in index_groups if pos in g)]

    def groups(self, axes: Axes, index_groups=None) -> list[list[int]]:
        """The partition of all ranks into the groups of ``group``."""
        seen, out = set(), []
        for r in range(self.size):
            if r not in seen:
                g = self.group(r, axes, index_groups)
                seen.update(g)
                out.append(g)
        return out

    def _check_index_groups(self, axes, index_groups) -> None:
        n = self.axis_size(axes)
        flat = sorted(i for g in index_groups for i in g)
        if flat != list(range(n)) or len({len(g) for g in index_groups}) != 1:
            raise ValueError(f"axis_index_groups {index_groups} do not split the {n} "
                             f"positions along {axes} into groups of one size")

    def peers(self, rank: int, axes: Axes, perm: Sequence[tuple[int, int]]):
        """(src, dst) global ranks of ``rank`` in a ppermute over ``axes``; None
        where no pair sends to it or it sends to no one."""
        axes = _as_tuple(axes)
        key = (axes, tuple((int(a), int(b)) for a, b in perm))
        table = self._peers.get(key)
        if table is None:
            table = self._peer_table(*key)
            with self._peers_lock:
                self._peers[key] = table
        return table[rank]

    def _peer_table(self, axes, perm):
        self._check_axes(axes)
        n = self.axis_size(axes)
        srcs, dsts = [a for a, _ in perm], [b for _, b in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or not all(
                0 <= i < n for i in srcs + dsts):
            raise ValueError(f"ppermute over {axes} (size {n}): {perm} is not a permutation")
        send, recv = dict(perm), {b: a for a, b in perm}
        table = []
        for r in range(self.size):
            g, i = self.group(r, axes), self.axis_index(r, axes)
            table.append((g[recv[i]] if i in recv else None, g[send[i]] if i in send else None))
        return table

    def _check_axes(self, axes: tuple[str, ...]) -> None:
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of the mesh {self.axis_names}")

    # -- transport (subclasses) --------------------------------------------

    def device(self, rank: int) -> torch.device:
        raise NotImplementedError

    def run(self, fn, *per_rank_args) -> list:
        """``fn(comm, *args)`` once for each rank of this process, ``args`` the
        rank's entries of ``per_rank_args`` (each a sequence indexed by global
        rank).  Returns the results in rank order: every rank's for a
        ``LocalMesh``, this process's one rank's for a ``DistMesh``."""
        raise NotImplementedError

    def _ppermute(self, rank, x, src, dst):
        raise NotImplementedError

    def _psum(self, rank, x, axes):
        raise NotImplementedError

    def _all_gather(self, rank, x, axes):
        raise NotImplementedError

    def _all_to_all(self, rank, x, axes, index_groups=None):
        raise NotImplementedError

    def _reduce_scatter(self, rank, x, axes):
        """The all-to-all of ``x``'s entries, then their sum in group order."""
        return ordered_sum(self._all_to_all(rank, x, axes)).to(x.dtype)

    def _check_args(self, per_rank_args) -> None:
        for a in per_rank_args:
            if len(a) != self.size:
                raise ValueError(f"run: an argument has {len(a)} entries for {self.size} ranks")


class Comm:
    """One rank's view of a mesh inside ``Mesh.run``: what ``shard_map``'s body
    reaches through ``lax``."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh, self.rank = mesh, rank
        self.device = mesh.device(rank)

    def axis_index(self, axes: Axes) -> int:
        return self.mesh.axis_index(self.rank, axes)

    def axis_size(self, axes: Axes) -> int:
        return self.mesh.axis_size(axes)

    def ppermute(self, x: torch.Tensor, axes: Axes, perm) -> torch.Tensor:
        if _tracks_grad(x):
            return _PPermute.apply(x, self, axes, tuple(perm))
        return self._send(x, axes, perm)

    def _send(self, x, axes, perm):
        src, dst = self.mesh.peers(self.rank, axes, perm)
        return self.mesh._ppermute(self.rank, x.contiguous(), src, dst)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        if _tracks_grad(x):
            return _PSum.apply(x, self, _as_tuple(axes))
        return self._sum(x, _as_tuple(axes))

    def _sum(self, x, axes):
        self.mesh.stats.record_call("psum", x.numel() * x.element_size())
        return self.mesh._psum(self.rank, x.contiguous(), axes)

    def pvary(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``x``, the same on every rank along ``axes``, as an input that each rank
        uses on its own (JAX's ``lax.pvary``): the identity, whose backward is the
        ``psum`` of the ranks' gradients.  With ``replicated_out`` it gives a
        replicated input of a ``shard_map`` body (``in_specs=P()``) the gradient
        JAX gives it."""
        if _tracks_grad(x):
            return _PVary.apply(x, self, _as_tuple(axes))
        return x

    def replicated_out(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``x``, computed alike on every rank along ``axes``, as a ``shard_map``
        output replicated over them (``out_specs=P()``, ``check_vma=False``): the
        identity, whose backward divides the gradient by the size of ``axes``, as
        JAX's transpose of such an output does.  Each rank's backward then carries
        its share, and a ``pvary`` input sums the shares."""
        if _tracks_grad(x):
            return _ScaleGrad.apply(x, 1.0 / self.mesh.axis_size(axes))
        return x

    def all_gather(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        if _tracks_grad(x):
            return _AllGather.apply(x, self, _as_tuple(axes))
        return self._gather(x, _as_tuple(axes))

    def _gather(self, x, axes):
        self.mesh.stats.record_call("all_gather", x.numel() * x.element_size())
        return self.mesh._all_gather(self.rank, x.contiguous(), axes)

    def reduce_scatter(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """Entry i of the group's sum of ``x`` (leading size: the ranks of the
        group) to the group's i-th rank (the module docstring)."""
        axes = _as_tuple(axes)
        n = len(self.mesh.group(self.rank, axes))
        if x.dim() == 0 or x.shape[0] != n:
            raise ValueError(f"reduce_scatter over {axes} needs a leading axis of {n}, got "
                             f"{tuple(x.shape)}")
        if _tracks_grad(x):
            return _ReduceScatter.apply(x, self, axes)
        return self._scatter(x, axes)

    def _scatter(self, x, axes):
        self.mesh.stats.record_call("reduce_scatter", x.numel() * x.element_size())
        nbytes = x[0].numel() * x.element_size()
        for g in self.mesh.group(self.rank, axes):
            if g != self.rank:
                self.mesh.stats.record_send(self.rank, g, nbytes)
        return self.mesh._reduce_scatter(self.rank, x.contiguous(), axes)

    def all_to_all(self, x: torch.Tensor, axes: Axes, axis_index_groups=None) -> torch.Tensor:
        """Entry i of ``x`` (leading size: the ranks of the group) to the group's
        i-th rank; entry j of the result from its j-th rank.  The group is the
        ranks along ``axes``, or with ``axis_index_groups`` (a partition of the
        positions along ``axes`` into parts of one size, as JAX's) the part
        that holds this rank.  Differentiable: the backward runs the same
        exchange on the gradient, so every rank of the group must run its
        backward too."""
        axes = _as_tuple(axes)
        if axis_index_groups is not None:
            axis_index_groups = tuple(tuple(int(i) for i in g) for g in axis_index_groups)
        n = len(self.mesh.group(self.rank, axes, axis_index_groups))
        if x.dim() == 0 or x.shape[0] != n:
            raise ValueError(f"all_to_all over {axes} needs a leading axis of {n}, got "
                             f"{tuple(x.shape)}")
        if _tracks_grad(x):
            return _AllToAll.apply(x, self, axes, axis_index_groups)
        return self._exchange_all(x, axes, axis_index_groups)

    def _exchange_all(self, x: torch.Tensor, axes: tuple[str, ...],
                      index_groups=None) -> torch.Tensor:
        self.mesh.stats.record_call("all_to_all", x.numel() * x.element_size())
        group = self.mesh.group(self.rank, axes, index_groups)
        nbytes = x[0].numel() * x.element_size()
        for g in group:
            if g != self.rank:
                self.mesh.stats.record_send(self.rank, g, nbytes)
        return self.mesh._all_to_all(self.rank, x.contiguous(), axes, index_groups)


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _PPermute(torch.autograd.Function):
    """``Comm.ppermute`` under autograd: the backward is the ppermute of the
    gradient over the reversed pairs (JAX's transpose rule)."""

    @staticmethod
    def forward(ctx, x, comm, axes, perm):
        ctx.comm, ctx.axes, ctx.perm = comm, axes, perm
        return comm._send(x, axes, perm)

    @staticmethod
    def backward(ctx, grad):
        back = [(b, a) for a, b in ctx.perm]
        return ctx.comm._send(grad, ctx.axes, back), None, None, None


class _PSum(torch.autograd.Function):
    """``Comm.psum`` under autograd: the output's gradient passes to the input."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm._sum(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _PVary(torch.autograd.Function):
    """``Comm.pvary``: the identity forward, the psum of the gradient backward."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm._sum(grad, ctx.axes), None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity forward; the gradient times ``scale`` backward."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class _AllGather(torch.autograd.Function):
    """``Comm.all_gather`` under autograd: the backward is the reduce_scatter of
    the gradient (JAX's transpose)."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm._gather(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm._scatter(grad, ctx.axes), None, None


class _ReduceScatter(torch.autograd.Function):
    """``Comm.reduce_scatter`` under autograd: the backward is the all_gather of
    the gradient (JAX's transpose)."""

    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return comm._scatter(x, axes)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm._gather(grad, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    """``Comm.all_to_all`` under autograd: the exchange, and the same exchange
    of the gradient (split and concat axes 0: its own inverse)."""

    @staticmethod
    def forward(ctx, x, comm, axes, index_groups):
        ctx.comm, ctx.axes, ctx.index_groups = comm, axes, index_groups
        return comm._exchange_all(x, axes, index_groups)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm._exchange_all(grad, ctx.axes, ctx.index_groups), None, None, None


class LocalMesh(Mesh):
    """Every rank a thread of this process, with its own device.

    ``devices`` is one device for all ranks (all 16 ranks of a 4×4 mesh on one
    GPU, or on the CPU) or a sequence of one device a rank.  Each collective
    posts the rank's tensor in its slot and waits at a barrier; each rank then
    copies what it needs onto its own device (``.to(device, copy=True)``).
    The slots alternate between two sets from one collective to the next, so
    a slot is posted again only after the next collective's barrier, which no
    rank passes before every rank has read: one barrier a collective (a psum
    takes two: one to post the parts, one to share their sum), not two.
    If one rank raises, the barrier is broken so that every other rank raises
    too, and ``run`` raises the first rank's own exception.  ``timeout``
    (seconds) bounds each wait, so ranks that disagree on the collectives they
    call fail rather than hang.

    Where several ranks share one GPU, the rank threads take turns: one runs at
    a time, from a collective to the next (a lock passed at each barrier).  The
    results are the same; the ranks' host work no longer overlaps, and on a
    shared GPU their host work is all there is to overlap and holds the GIL
    anyway: without turns, 16 threads contend for the GIL at every op each of
    them dispatches.  Only the rank threads take turns: a collective that an
    autograd thread runs (a backward) waits at the barrier without a turn.
    """

    def __init__(self, shape, axis_names, devices, timeout: float = 300.0):
        super().__init__(shape, axis_names)
        if isinstance(devices, (str, torch.device)):
            devices = [torch.device(devices)] * self.size
        self.devices = [torch.device(d) for d in devices]
        if len(self.devices) != self.size:
            raise ValueError(f"LocalMesh: {len(self.devices)} devices for {self.size} ranks")
        self.timeout = timeout
        self._slots: list = [[None] * self.size, [None] * self.size]
        self._calls = [0] * self.size  # collectives each rank has called in this run
        self._barrier: threading.Barrier | None = None
        self._baton = threading.Lock() if _takes_turns(self.devices) else None
        self._turn = threading.local()  # .held: this thread holds the baton

    def device(self, rank: int) -> torch.device:
        return self.devices[rank]

    def _take(self) -> None:
        """With turns, wait for this rank thread's turn.  No turn within ``timeout``
        means the ranks are stuck, as a barrier's timeout does: the barrier is
        broken and this rank raises ``BrokenBarrierError``."""
        if self._baton is None:
            return
        if not self._baton.acquire(timeout=self.timeout):
            self._barrier.abort()
            raise threading.BrokenBarrierError(f"LocalMesh: no turn within {self.timeout} s")
        self._turn.held = True

    def _give(self) -> bool:
        """Give up this thread's turn; whether it held one."""
        if self._baton is None or not getattr(self._turn, "held", False):
            return False
        self._turn.held = False
        self._baton.release()
        return True

    def run(self, fn, *per_rank_args) -> list:
        self._check_args(per_rank_args)
        self._barrier = barrier = threading.Barrier(self.size, timeout=self.timeout)
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(rank):
            try:
                self._take()
                try:
                    results[rank] = fn(Comm(self, rank), *(a[rank] for a in per_rank_args))
                finally:
                    self._give()
            except BaseException as e:  # re-raised by run, in the caller's thread
                errors[rank] = e
                barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), name=f"rank{r}", daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [[None] * self.size, [None] * self.size]
        self._calls = [0] * self.size
        self._barrier = None
        raised = [e for e in errors if e is not None]
        own = [e for e in raised if not isinstance(e, threading.BrokenBarrierError)]
        if raised:
            raise (own or raised)[0]
        return results

    def _exchange(self, rank, x, read):
        """Post ``x``, wait for every rank's post, and return ``read(slots)``."""
        if self._barrier is None:
            raise RuntimeError("LocalMesh collectives run inside LocalMesh.run only")
        slots = self._slots[self._calls[rank] % 2]
        self._calls[rank] += 1
        slots[rank] = x
        turn = self._give()
        try:
            self._barrier.wait()
        finally:
            if turn:
                self._take()
        return read(slots)

    def _ppermute(self, rank, x, src, dst):
        if dst is not None:
            self.stats.record_send(rank, dst, x.numel() * x.element_size())
        dev = self.devices[rank]

        def read(slots):
            if src is None:
                return torch.zeros_like(x)
            return _copy(slots[src], dev)

        return self._exchange(rank, x, read)

    def _psum(self, rank, x, axes):
        """The group's first rank adds the parts in group order, and every other rank
        takes a copy of its sum: the same bits on every rank, one sum a group
        (two barriers)."""
        dev, group = self.devices[rank], self.group(rank, axes)
        lead = group[0]

        def total(slots):
            if rank != lead:
                return None
            out = _copy(slots[lead], dev)
            for g in group[1:]:
                out += _on(slots[g], dev)
            return out

        out = self._exchange(rank, x, total)
        shared = self._exchange(rank, out, lambda slots: slots[lead])
        return out if rank == lead else _copy(shared, dev)

    def _all_gather(self, rank, x, axes):
        dev, group = self.devices[rank], self.group(rank, axes)
        return self._exchange(rank, x, lambda slots: torch.stack([_on(slots[g], dev)
                                                                  for g in group]))

    def _all_to_all(self, rank, x, axes, index_groups=None):
        dev, group = self.devices[rank], self.group(rank, axes, index_groups)
        i = group.index(rank)
        return self._exchange(rank, x, lambda slots: torch.stack([_on(slots[g][i], dev)
                                                                  for g in group]))


def pieces(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` flat in float32 (float64 stays float64), zero-padded to ``n`` equal
    pieces: (n, -1), the input of a ``reduce_scatter`` that sums ``x`` over a
    group of ``n``."""
    flat = x.reshape(-1)
    if flat.dtype not in (torch.float32, torch.float64):
        flat = flat.float()
    if flat.numel() % n:
        flat = torch.nn.functional.pad(flat, (0, -flat.numel() % n))
    return flat.reshape(n, -1)


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum of ``parts`` over its first axis, in that order, in float32
    (float64 stays float64)."""
    total = parts[0].to(torch.float64 if parts.dtype == torch.float64 else torch.float32,
                        copy=True)
    for part in parts[1:]:
        total += part
    return total


def _takes_turns(devices: Sequence[torch.device]) -> bool:
    """Whether rank threads on ``devices`` take turns: several share one GPU."""
    gpus = [(d.type, d.index or 0) for d in devices if d.type != "cpu"]
    return len(set(gpus)) < len(gpus)


def _on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself where it is there already (no dispatch, which on
    rank threads is a turn of the GIL), else a copy there."""
    if t.device.type == dev.type and (dev.index is None or t.device.index == dev.index):
        return t
    return t.to(dev)


def _copy(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A copy of ``t`` on ``dev``."""
    out = _on(t, dev)
    return out.clone() if out is t else out


class TraceMesh(Mesh):
    """A mesh of named axes with no peers and no threads: the dry-run's mesh.

    ``run(fn, *per_rank_args)`` calls ``fn(Comm(mesh, r), ...)`` in the calling
    thread for each rank of ``ranks`` (rank 0 by default), in that order, and
    returns their results, so that dispatch modes entered by the caller (fake
    tensors, ``FlopCounterMode``) see every op.  The collectives need no peer:
    each returns a placeholder of the collective's shape and dtype on ``x``'s
    device, made from ``x`` alone (a copy of it; ``n`` copies stacked for
    all_gather; its first entry for reduce_scatter; zeros for a ppermute that
    no pair sends to the rank), whose
    values are not the collective's.  ``stats`` counts, for the ranks run,
    what a ``LocalMesh`` counts for them; ``calls`` adds, a call, the
    collective's kind (the HLO op's name), its result bytes and its group size,
    which the dry-run's wire model reads.
    """

    def __init__(self, shape, axis_names, ranks=(0,)):
        super().__init__(shape, axis_names)
        self.ranks = tuple(ranks)
        self.calls: list[tuple[int, str, int, int]] = []  # (rank, kind, bytes, group)

    def device(self, rank: int) -> torch.device:
        return torch.device("cpu")  # the dry-run traces fake CPU tensors

    def run(self, fn, *per_rank_args) -> list:
        self._check_args(per_rank_args)
        return [fn(Comm(self, r), *(a[r] for a in per_rank_args)) for r in self.ranks]

    def _record(self, rank, kind, out, group):
        self.calls.append((rank, kind, out.numel() * out.element_size(), group))
        return out

    def _ppermute(self, rank, x, src, dst):
        if dst is not None:
            self.stats.record_send(rank, dst, x.numel() * x.element_size())
        out = torch.zeros_like(x) if src is None else x.clone()
        return self._record(rank, "collective-permute", out, 1)

    def _psum(self, rank, x, axes):
        return self._record(rank, "all-reduce", x.clone(), self.axis_size(axes))

    def _all_gather(self, rank, x, axes):
        n = self.axis_size(axes)
        return self._record(rank, "all-gather", x.expand((n,) + tuple(x.shape)).clone(), n)

    def _all_to_all(self, rank, x, axes, index_groups=None):
        return self._record(rank, "all-to-all", x.clone(),
                            len(self.group(rank, axes, index_groups)))

    def _reduce_scatter(self, rank, x, axes):
        return self._record(rank, "reduce-scatter", x[0].clone(), self.axis_size(axes))


class DistMesh(Mesh):
    """This process's rank of the default ``torch.distributed`` process group.

    The group must be initialised, with as many ranks as the mesh has, and
    ``device`` is where this rank's tensors live (the CPU for gloo; this
    process's GPU for NCCL, which also wants ``torch.cuda.set_device``).  The
    constructor runs one all-reduce over every rank: NCCL wants the first
    collective of a group to involve all its ranks before a batched P2P.
    Sub-axis psums and all_gathers create their subgroups on first use, with
    every rank taking part, as the SPMD code does.
    """

    def __init__(self, shape, axis_names, device="cpu"):
        import torch.distributed as dist

        super().__init__(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs torch.distributed.init_process_group first")
        if dist.get_world_size() != self.size:
            raise ValueError(f"DistMesh: mesh of {self.size} ranks on a process group of "
                             f"{dist.get_world_size()}")
        self._dist = dist
        self.rank = dist.get_rank()
        self._device = torch.device(device)
        self._subgroups: dict = {}
        dist.all_reduce(torch.zeros(1, device=self._device))

    def device(self, rank: int) -> torch.device:
        return self._device

    def run(self, fn, *per_rank_args) -> list:
        self._check_args(per_rank_args)
        return [fn(Comm(self, self.rank), *(a[self.rank] for a in per_rank_args))]

    def _process_group(self, axes, index_groups=None):
        """The process group of this rank's group over ``axes`` (None: the world).

        The first call for ``(axes, index_groups)`` creates the subgroup of every
        group of the partition, on every rank, in one order.
        """
        if index_groups is None and self.axis_size(axes) == self.size:
            return None
        key = (axes, index_groups)
        if key not in self._subgroups:
            parts = self.groups(axes, index_groups)
            _, pgs = self._dist.new_subgroups_by_enumeration(parts)
            self._subgroups[key] = {frozenset(g): pg for g, pg in zip(parts, pgs)}
        return self._subgroups[key][frozenset(self.group(self.rank, axes, index_groups))]

    def _ppermute(self, rank, x, src, dst):
        dist = self._dist
        if dst is not None:
            self.stats.record_send(rank, dst, x.numel() * x.element_size())
        if dst == rank:  # a pair (r, r): src is rank too
            return x.clone()
        out = torch.empty_like(x) if src is not None else torch.zeros_like(x)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, x, dst))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _psum(self, rank, x, axes):
        out = x.clone()
        self._dist.all_reduce(out, group=self._process_group(axes))
        return out

    def _all_gather(self, rank, x, axes):
        group = self.group(rank, axes)
        out = torch.empty(len(group) * x.numel(), dtype=x.dtype, device=x.device)
        self._dist.all_gather_into_tensor(out, x.reshape(-1), group=self._process_group(axes))
        out = out.reshape((len(group),) + tuple(x.shape))
        # a process group orders its ranks by global rank; the mesh by position
        order = sorted(group)
        return out[[order.index(g) for g in group]] if order != group else out

    def _all_to_all(self, rank, x, axes, index_groups=None):
        group = self.group(rank, axes, index_groups)
        order = sorted(group)  # the process group's order of its ranks
        if order != group:  # entry j of the exchange goes to order[j]
            x = x[[group.index(g) for g in order]].contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x, group=self._process_group(axes, index_groups))
        return out[[order.index(g) for g in group]] if order != group else out
