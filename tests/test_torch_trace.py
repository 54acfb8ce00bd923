"""The port's tracer (``repro_torch.trace``) on the CPU: off, it leaves the
program as it was; on, its spans carry the right phases, parents and steps,
its counters count what the MoE's dispatch keeps, and its records stay whole
across rank threads."""

import collections
import dataclasses
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import torch.utils.checkpoint  # noqa: E402

from repro_torch import trace  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.parallel.sharding import Policy  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps  # noqa: E402

torch.set_num_threads(2)

MOE = ArchConfig("tiny-moe", "moe", 2, 32, 4, 2, 48, 96, n_experts=4, top_k=2)
DENSE = ArchConfig("tiny", "dense", 2, 32, 4, 2, 64, 128)
HARNESS_RANGES = ("moe", "attention", "optimizer", "step", "call", "window")


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _params(cfg):
    return T.init_params(cfg, torch.Generator().manual_seed(1), torch.float32)


def _batch(cfg, b=2, s=16, seed=0):
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(seed))
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _train(cfg, traced: bool, n_steps=1, **options):
    """(params, the last step's metrics, the first step's gradients) after
    ``n_steps`` AdamW steps from ``_params``, the tracer on where ``traced``."""
    params = _params(cfg)
    topts = steps.TrainOptions(remat=True, use_kernel=True, **options)
    grad_fn = steps.value_and_grad(steps.make_loss_fn(cfg, topts))
    step = steps.make_train_step(cfg, opt.AdamWConfig(), topts)
    if traced:
        trace.enable()
    _, grads = grad_fn(params, _batch(cfg))
    trace.reset()
    state = opt.init(params)
    for i in range(n_steps):
        params, state, metrics = step(params, state, _batch(cfg, seed=i))
    trace.disable()
    return params, metrics, grads


def _labels(snap):
    return [(r.label, None if r.parent is None else snap.records[r.parent].label, r.step)
            for r in snap.records]


def test_names_are_registered_once_and_apart_from_the_harness_ranges():
    assert len(set(trace.NAMES)) == len(trace.NAMES)
    assert not set(trace.NAMES) & set(HARNESS_RANGES)
    assert set(trace.NAMES) == {f"{n}.{p}" for n, ps in trace.PHASES.items() for p in ps}
    assert {"attn.bwd", "layer.recompute", "moe.experts.bwd", "train_step.fwd"} <= set(trace.NAMES)
    # innermost first: a span's name comes before every span it can open inside
    order = list(trace.PHASES)
    for inner, outer in [("moe.experts", "moe"), ("moe", "layer"), ("mlp", "layer"),
                         ("norm", "head"), ("attn", "layer"), ("layer", "train_step"),
                         ("head", "prefill"), ("opt", "train_step")]:
        assert order.index(inner) < order.index(outer)
    trace.enable()
    with pytest.raises(KeyError):
        trace.span("attention")
    with pytest.raises(ValueError):
        trace.span("opt", "bwd")
    with pytest.raises(ValueError):
        trace.count("moe.dropped", 1)


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("on", [False, True])
def test_off_the_span_is_one_shared_no_op_and_no_mark_enters_the_graph(on):
    if on:
        trace.enable()
    a, b = trace.span("layer"), trace.span("moe")
    assert (a is b) != on
    x = torch.randn(3, requires_grad=True)
    with a as sp:
        assert sp.inputs(x) is x if not on else sp.inputs(x) is not x
    params, batch = _params(MOE), _batch(MOE)
    loss_fn = steps.make_loss_fn(MOE, steps.TrainOptions(remat=True, use_kernel=True))
    flat, spec = tree_lib.flatten(params)
    views = [p.detach().requires_grad_(True) for p in flat]
    loss, _ = loss_fn(tree_lib.unflatten(spec, views), batch)
    assert ("_MarkBackward" in _graph_nodes(loss)) == on
    assert bool(trace.snapshot().records) == on


@pytest.mark.parametrize("cfg", [MOE, DENSE], ids=["moe", "dense"])
def test_losses_and_gradients_are_the_same_bits_with_tracing_on(cfg):
    off_params, off_m, off_grads = _train(cfg, False, n_steps=2)
    on_params, on_m, on_grads = _train(cfg, True, n_steps=2)
    assert torch.equal(off_m["loss"], on_m["loss"]) and torch.equal(off_m["aux"], on_m["aux"])
    for a, b in zip(tree_lib.leaves(off_grads), tree_lib.leaves(on_grads)):
        assert torch.equal(a, b)
    for a, b in zip(tree_lib.leaves(off_params), tree_lib.leaves(on_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cfg", [MOE, DENSE], ids=["moe", "dense"])
def test_every_region_shows_its_phases_parents_and_step(cfg):
    _train(cfg, True, n_steps=2)
    snap = trace.snapshot()
    assert snap.steps == [0, 1]
    got = collections.Counter(_labels(snap))
    n = cfg.n_layers
    body = ("moe", "moe.experts") if cfg.family == "moe" else ("mlp",)
    # the recompute starts where the backward first needs a saved tensor: inside
    # the backward of the region that made the layer's last output
    starts = {"moe": "moe.bwd", "dense": "mlp.bwd"}[cfg.family]
    for step in (0, 1):
        want = {("train_step.fwd", None, step): 1, ("opt.fwd", "train_step.fwd", step): 1,
                ("head.fwd", "train_step.fwd", step): 1, ("head.bwd", "train_step.fwd", step): 1,
                ("loss.fwd", "train_step.fwd", step): 1, ("loss.bwd", "train_step.fwd", step): 1,
                ("norm.fwd", "head.fwd", step): 1,
                ("layer.fwd", "train_step.fwd", step): n,
                ("layer.recompute", starts, step): n,
                ("layer.bwd", "train_step.fwd", step): n,
                ("attn.bwd", "layer.bwd", step): n,
                ("norm.fwd", "layer.fwd", step): 2 * n,
                ("norm.recompute", "layer.recompute", step): 2 * n,
                ("rope.fwd", "layer.fwd", step): n,
                ("rope.recompute", "layer.recompute", step): n}
        for name in body:
            parent = {"moe.experts": "moe"}.get(name, "layer")
            for phase in trace.ALL:
                want[(f"{name}.{phase}", f"{parent}.{phase}", step)] = n
        assert {k: v for k, v in got.items() if k[2] == step} == want
    # a span's self time is its time less its children's: they add up to the step's
    for step in snap.steps:
        total = sum(r.self_ms for r in snap.records if r.step == step)
        assert total == pytest.approx(snap.ms("train_step", step=step), rel=1e-9)
    assert all(r.ms >= 0 for r in snap.records)
    assert trace._stack() == []


def test_the_loss_and_head_of_a_chunked_cross_entropy_are_spans_too():
    _train(DENSE, True, ce_chunk=8)
    got = collections.Counter((label, parent) for label, parent, _ in _labels(trace.snapshot()))
    assert got[("head.fwd", "train_step.fwd")] == got[("head.bwd", "train_step.fwd")] == 1
    assert got[("loss.fwd", "train_step.fwd")] == got[("loss.bwd", "train_step.fwd")] == 1


def test_a_span_that_an_early_stopped_recompute_leaves_is_closed():
    """Checkpoint's recompute stops with an exception once it has rebuilt the
    last saved tensor (here ``exp``'s output, inside the inner span): both spans
    open at that point are closed, in the recompute phase."""
    reached = []

    def region(x):
        with trace.span("layer"):
            y = x.sin()
            with trace.span("moe"):
                w = (y * 2).exp()
                reached.append(torch._C._current_graph_task_id())
                return w + 1

    trace.enable()
    x = torch.randn(4, requires_grad=True)
    torch.utils.checkpoint.checkpoint(region, x, use_reentrant=False).sum().backward()
    assert reached == [-1]  # the recompute never got past exp
    labels = [(label, parent) for label, parent, _ in _labels(trace.snapshot())]
    assert labels == [("moe.fwd", "layer.fwd"), ("layer.fwd", None),
                      ("moe.recompute", "layer.recompute"), ("layer.recompute", None)]
    assert trace._stack() == []


def test_the_moe_counters_equal_a_recount_of_the_dispatch():
    """``moe.pairs``, ``moe.kept`` and ``moe.slots`` against a loop over every
    forward pass's (token, choice) pairs in token-major order: a pair fits while
    its expert has fewer than the capacity before it.  At capacity factor 1.0
    some pairs drop; the recompute counts nothing."""
    cfg = dataclasses.replace(MOE, capacity_factor=1.0)
    chosen, route = [], moe._route

    def recorded(*args, **kwargs):
        gates, experts, aux = route(*args, **kwargs)
        if torch._C._current_graph_task_id() == -1:
            chosen.append(experts.clone())
        return gates, experts, aux

    with mock.patch.object(moe, "_route", recorded):
        _train(cfg, True, n_steps=2)
    chosen = chosen[cfg.n_layers:]  # the gradient call before the steps: reset away
    pairs = kept = slots = 0
    for experts in chosen:
        g, t, k = experts.shape
        cap = moe.capacity(t, k, cfg.n_experts, cfg.capacity_factor)
        for group in experts.tolist():
            seen = [0] * cfg.n_experts
            for e in (e for token in group for e in token):
                kept += seen[e] < cap
                seen[e] += 1
                pairs += 1
        slots += g * cfg.n_experts * cap
    assert len(chosen) == 2 * cfg.n_layers and kept < pairs
    assert trace.snapshot().counters == {"moe.pairs": pairs, "moe.kept": kept,
                                         "moe.slots": slots}


def test_records_stay_whole_over_the_rank_threads_of_a_local_mesh():
    """A ring-synced step over a 4-rank ``LocalMesh``: each rank's forward and
    backward run on a thread of its own, under the step's root."""
    mesh = make_test_mesh((4, 1), ("data", "model"), "cpu")
    step = steps.make_train_step(DENSE, opt.AdamWConfig(), steps.TrainOptions(
        remat=True, use_kernel=True, sync="ring"), Policy(data_axes=("data",)), mesh)
    params = _params(DENSE)
    trace.enable()
    step(params, opt.init(params), _batch(DENSE, b=8))
    trace.disable()
    snap = trace.snapshot()
    got = collections.Counter(_labels(snap))
    ranks, n = 4, DENSE.n_layers
    for label, parent, count in [("layer.fwd", "train_step.fwd", ranks * n),
                                 ("layer.bwd", "train_step.fwd", ranks * n),
                                 ("layer.recompute", "mlp.bwd", ranks * n),
                                 ("mlp.recompute", "layer.recompute", ranks * n),
                                 ("mlp.bwd", "layer.bwd", ranks * n),
                                 ("attn.bwd", "layer.bwd", ranks * n),
                                 ("loss.bwd", "train_step.fwd", ranks),
                                 ("opt.fwd", "train_step.fwd", 1)]:
        assert got[(label, parent, 0)] == count, label
    assert got[("train_step.fwd", None, 0)] == 1 and sum(got.values()) == len(snap.records)
    assert sum(r.self_ms for r in snap.records) == pytest.approx(snap.ms("train_step"))


def test_a_prefill_call_is_a_root_with_its_head_norms_and_rope():
    step = steps.make_prefill_step(DENSE, steps.TrainOptions(use_kernel=True))
    params = _params(DENSE)
    trace.enable()
    for i in range(2):
        step(params, _batch(DENSE, seed=i))
    snap = trace.snapshot()
    got = collections.Counter(_labels(snap))
    n = DENSE.n_layers
    for call in (0, 1):
        assert {k: v for k, v in got.items() if k[2] == call} == {
            ("prefill.fwd", None, call): 1, ("head.fwd", "prefill.fwd", call): 1,
            ("norm.fwd", "head.fwd", call): 1, ("layer.fwd", "prefill.fwd", call): n,
            ("norm.fwd", "layer.fwd", call): 2 * n, ("rope.fwd", "layer.fwd", call): n,
            ("mlp.fwd", "layer.fwd", call): n}


# the per-layer readings the tracer gives a benchmark window, a training step's
# or a prefill call's worth each (PERF.md, section 3)
READINGS = {
    "attn_bwd_ms.train": lambda s: s.ms("attn", own=True),
    "head_loss_ms.train": lambda s: s.ms("head") + s.ms("loss"),
    "recompute_ms.train": lambda s: s.ms("layer", ("recompute",)),
    "mlp_ms.train": lambda s: s.ms("mlp", own=True),
    "moe_experts_ms.train": lambda s: s.ms("moe.experts", own=True),
    "moe_dispatch_ms.train": lambda s: s.ms("moe", own=True),
    "head_ms.prefill": lambda s: s.ms("head", ("fwd",)),
    "norm_rope_ms.prefill": lambda s: s.ms("norm", ("fwd",)) + s.ms("rope", ("fwd",)),
}


@pytest.mark.parametrize("cell,names", [
    ("mixtral-train", ("attn_bwd_ms.train", "head_loss_ms.train", "recompute_ms.train",
                       "moe_experts_ms.train", "moe_dispatch_ms.train")),
    ("qwen2vl-train", ("attn_bwd_ms.train", "head_loss_ms.train", "recompute_ms.train",
                       "mlp_ms.train")),
    ("qwen2vl-prefill", ("head_ms.prefill", "norm_rope_ms.prefill")),
])
def test_a_benchmark_window_at_tiny_sizes_gives_every_reading(cell, names):
    """The benchmark's window (``portbench.harness``, ``portbench/tiny.py``'s
    sizes) with the tracer enabled and reset where the window starts: one root
    a step or call of the window, and every reading of the cell above 0."""
    from portbench import harness
    from portbench.tiny import tiny

    run = harness.Run(tiny(cell), 2**31 + 3, 1e-3, False, "cpu", 0.0)
    counters = run._reset_counters

    def window_starts():
        counters()
        trace.enable()
        trace.reset()

    with mock.patch.object(run, "_reset_counters", window_starts):
        w = run.measure_train() if "train" in cell else run.measure_prefill()
    trace.disable()
    snap = trace.snapshot()
    assert w.units >= 1 and snap.steps == list(range(w.units))
    for name in names:
        assert READINGS[name](snap) > 0, name
    if cell == "mixtral-train":
        c = snap.counters
        assert 0 < c["moe.kept"] <= min(c["moe.pairs"], c["moe.slots"])
    else:
        assert not snap.counters and not any(r.name.startswith("moe") for r in snap.records)


class _Event:
    def __init__(self, name, start, end, cuda):
        self._n, self._s, self._e, self._cuda = name, start, end, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU


def test_the_trace_reduction_takes_the_program_ranges_as_labels():
    """``portbench.trace.reduce`` given ``trace.NAMES`` before the harness's own
    labels: the device's copies of the program's ranges are no work, and a gap
    is labelled by the innermost program range open around it.  Without them
    the copies would count as device operations."""
    from types import SimpleNamespace

    from portbench import harness
    from portbench import trace as bench_trace

    host = [("window", 0, 1000), ("step", 0, 1000), ("train_step.fwd", 10, 990),
            ("layer.bwd", 100, 600), ("attn.bwd", 300, 500)]
    device = [("gemm", 100, 350), ("gemm", 360, 600), ("layer.bwd", 100, 600),
              ("attn.bwd", 300, 500), ("gemm", 640, 990)]
    events = [_Event(n, a, b, False) for n, a, b in host] + [_Event(n, a, b, True)
                                                             for n, a, b in device]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    t = bench_trace.reduce(prof, "window", "step", (*trace.NAMES, *harness.LABELS))
    assert [n for n, _ in t["device_ops"]] == ["gemm"]
    assert t["busy_s"] == pytest.approx((250 + 240 + 350) * 1e-9)
    assert t["idle_gaps"] == [["train_step.fwd", pytest.approx(40e-9)],
                              ["attn.bwd", pytest.approx(10e-9)]]
    t = bench_trace.reduce(prof, "window", "step", harness.LABELS)
    assert {"layer.bwd", "attn.bwd"} <= {n for n, _ in t["device_ops"]}
