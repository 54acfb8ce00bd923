"""Spans and counters at the program's layer boundaries, off unless ``enable()``.

A span is a ``torch.profiler.record_function`` range named ``<name>.<phase>``,
so that a profiler's trace shows it beside the kernels it launched, and two
CUDA events on the current stream (on a machine without CUDA, the host's
clock), read once, at ``snapshot()``.  There is no exporter: the profiler's
trace is the timeline, and ``snapshot()`` gives the sums.

The phase of a span is

* ``fwd``: opened in a forward pass;
* ``recompute``: opened while autograd runs a graph task, which is
  ``torch.utils.checkpoint``'s second forward pass inside the backward.
  ``__exit__`` runs when an exception leaves the block, so a recompute that
  checkpoint stops early (once the last saved tensor is rebuilt) is timed up
  to where it stopped;
* ``bwd``: the backward of a forward region, opened and closed by identity
  autograd Functions at the region's outputs and inputs (``Span.outputs``,
  ``Span.inputs``).  They enter the graph only while tracing is on, so with
  it off the graph is the one the program builds without tracing.  A region
  whose inputs reach it by no marked path has no ``bwd`` span: its backward
  counts in its parent's.  The flash kernel's backward opens ``attn.bwd``
  itself (``kernels/ops.py``).

Each record holds the span's name, phase, parent (the innermost span open on
its thread, else the open root: autograd's device thread and a ``LocalMesh``
rank's thread start with none open) and the index of the step or call that
the root (``train_step``, ``prefill``) set.  Records are kept under a lock;
the stack of open spans is each thread's own.  ``count`` adds a number, a
device scalar included, on the device, in forward passes only; the totals are
read at ``snapshot()``.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

FORWARD = ("fwd", "recompute")
ALL = ("fwd", "recompute", "bwd")
# every span and the phases it can have, innermost first
PHASES = {
    "attn": ("bwd",),
    "norm": FORWARD,
    "rope": FORWARD,
    "moe.experts": ALL,
    "moe": ALL,
    "mlp": ALL,
    "layer": ALL,
    "head": ALL,
    "loss": ALL,
    "opt": ("fwd",),
    "train_step": ("fwd",),
    "prefill": ("fwd",),
}
ROOTS = ("train_step", "prefill")
# the profiler range of every span and phase, innermost first
NAMES = tuple(f"{name}.{phase}" for name, phases in PHASES.items() for phase in phases)
COUNTERS = ("moe.pairs", "moe.kept", "moe.slots")

_on = False
_cuda = False
_lock = threading.Lock()
_local = threading.local()
_records: list[Span] = []
_counts: dict = {}
_root: Span | None = None
_step = -1


def enable() -> None:
    """Spans and counters on from here (CUDA events where CUDA is available)."""
    global _on, _cuda
    _cuda = torch.cuda.is_available()
    _on = True


def disable() -> None:
    """Off from here; the records stay until ``reset``."""
    global _on
    _on = False


def on() -> bool:
    return _on


def reset() -> None:
    """Drops every record and counter; the next root is step 0."""
    global _records, _counts, _step
    with _lock:
        _records, _counts, _step = [], {}, -1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _graph_task() -> bool:
    return torch._C._current_graph_task_id() != -1


def _one(xs):
    return xs[0] if len(xs) == 1 else xs


class _Off:
    """The span while tracing is off: no range, no event, no mark."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def inputs(*xs):
        return _one(xs)

    outputs = inputs


_OFF = _Off()


def span(name: str, phase: str | None = None):
    """The span ``name`` (one of ``PHASES``) as a context manager; ``phase`` is
    given only by a backward pass that opens its own (``attn``)."""
    if not _on:
        return _OFF
    return Span(name, phase or ("recompute" if _graph_task() else "fwd"))


class Span:
    def __init__(self, name: str, phase: str):
        if phase not in PHASES[name]:
            raise ValueError(f"span {name!r} has no phase {phase!r}")
        self.name, self.phase = name, phase
        self._bwd = _Backward(name) if "bwd" in PHASES[name] and phase == "fwd" else None
        self._marked = False

    @property
    def label(self) -> str:
        return f"{self.name}.{self.phase}"

    def __enter__(self):
        global _root, _step
        stack = _stack()
        if self.name in ROOTS:
            with _lock:
                _step += 1
                self.parent, self.step, _root = None, _step, self
        else:
            self.parent, self.step = (stack[-1] if stack else _root), _step
        self._range = torch.profiler.record_function(self.label)
        self._range.__enter__()
        self.start = self.end = None
        if _cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _root
        if _cuda:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        self.t1 = time.perf_counter()
        self._range.__exit__(*exc)
        stack = _stack()
        if self in stack:
            stack.remove(self)
        with _lock:
            if _root is self:
                _root = None
            _records.append(self)
        return False

    def ms(self) -> float:
        if self.start is not None:
            return self.start.elapsed_time(self.end)
        return (self.t1 - self.t0) * 1e3

    def inputs(self, *xs):
        """``xs`` through a mark whose backward closes this region's ``bwd`` span."""
        if self._bwd is None or not torch.is_grad_enabled():
            return _one(xs)
        out = _mark(self._bwd, False, xs)
        self._marked = out is not xs
        return _one(out)

    def outputs(self, *xs):
        """``xs`` through a mark whose backward opens this region's ``bwd`` span
        (only where ``inputs`` marked a tensor that needs a gradient)."""
        if not self._marked or not torch.is_grad_enabled():
            return _one(xs)
        return _one(_mark(self._bwd, True, xs))


class _Backward:
    """A forward region's ``bwd`` span between its two marks."""

    def __init__(self, name: str):
        self.name, self.span = name, None

    def open(self) -> None:
        if _on and self.span is None:
            self.span = Span(self.name, "bwd").__enter__()

    def close(self) -> None:
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.span = None


class _Mark(torch.autograd.Function):
    """The identity; its backward opens or closes a region's ``bwd`` span."""

    @staticmethod
    def forward(ctx, bwd, opens, *xs):
        ctx.bwd, ctx.opens = bwd, opens
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.bwd.open() if ctx.opens else ctx.bwd.close()
        return (None, None, *grads)


def _mark(bwd: _Backward, opens: bool, xs: tuple) -> tuple:
    """``xs`` with the tensors that need a gradient through one ``_Mark``; ``xs``
    itself where none does."""
    at = [i for i, x in enumerate(xs) if isinstance(x, torch.Tensor) and x.requires_grad]
    if not at:
        return xs
    marked = _Mark.apply(bwd, opens, *(xs[i] for i in at))
    out = list(xs)
    for i, x in zip(at, marked):
        out[i] = x
    return tuple(out)


def count(name: str, value) -> None:
    """Adds ``value`` (a number or a device scalar, added on its device) to the
    counter ``name`` (one of ``COUNTERS``), in forward passes only."""
    if not _on or _graph_task():
        return
    if name not in COUNTERS:
        raise ValueError(f"no counter {name!r}")
    with _lock:
        old = _counts.get(name)
        _counts[name] = value if old is None else old + value


@dataclasses.dataclass(frozen=True)
class Record:
    name: str
    phase: str
    parent: int | None  # the parent's index among the records, None for none
    step: int
    ms: float  # device ms from the span's start to its end (host ms without CUDA)
    self_ms: float  # ms less its children's

    @property
    def label(self) -> str:
        return f"{self.name}.{self.phase}"


@dataclasses.dataclass(frozen=True)
class Snapshot:
    records: tuple[Record, ...]
    counters: dict

    def ms(self, name: str, phases=ALL, step: int | None = None, own: bool = False) -> float:
        """Sum of the ms (``own``: the self ms) of ``name``'s records in ``phases``,
        of every step or of ``step``."""
        return sum(r.self_ms if own else r.ms for r in self.records
                   if r.name == name and r.phase in phases and (step is None or r.step == step))

    @property
    def steps(self) -> list[int]:
        """The indices of the steps or calls whose root closed."""
        return sorted({r.step for r in self.records if r.name in ROOTS})


def snapshot() -> Snapshot:
    """The closed spans' records and the counters' totals (reads the device)."""
    with _lock:
        spans, counts = list(_records), dict(_counts)
    if any(s.start is not None for s in spans):
        torch.cuda.synchronize()
    ms = [s.ms() for s in spans]
    index = {id(s): i for i, s in enumerate(spans)}
    own = list(ms)
    parents = [index.get(id(s.parent)) for s in spans]
    for i, p in enumerate(parents):
        if p is not None:
            own[p] -= ms[i]
    records = tuple(Record(s.name, s.phase, p, s.step, m, o)
                    for s, p, m, o in zip(spans, parents, ms, own))
    return Snapshot(records, {k: v.item() if isinstance(v, torch.Tensor) else v
                              for k, v in counts.items()})
