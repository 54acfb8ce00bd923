"""One run of one cell: set-up, the measured window, the check of its outputs,
and the result line.

Everything that belongs to one configuration, traffic mix, metric or cell sits
in a file of its own under this folder, found by the name ``BENCHMARK.json``
gives it: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` and ``limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import gc
from contextlib import contextmanager, nullcontext
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

import torch

from portbench import check, feed, trace, weights
from portbench.reference import model as ref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRAFFIC = HERE / "traffic"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names no run may load

# the program's names of a configuration's sizes, from the published config's keys
ARCH_KEYS = {
    "n_layers": ("num_hidden_layers",),
    "d_model": ("hidden_size",),
    "n_heads": ("num_attention_heads",),
    "n_kv_heads": ("num_key_value_heads",),
    "d_ff": ("moe_intermediate_size", "intermediate_size"),
    "vocab": ("vocab_size",),
    "rope_theta": ("rope_theta",),
}
EXPERT_KEYS = {"n_experts": ("num_local_experts", "n_routed_experts", "num_experts"),
               "top_k": ("num_experts_per_tok",)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# host ranges that label the device's idle gaps, innermost first
LABELS = ("moe", "attention", "optimizer", "step", "call", "window")
TRAIN_SPANS = {"moe": ("repro_torch.models.moe", "moe_apply"),
               "attention": ("repro_torch.models.layers", "attention"),
               "optimizer": ("repro_torch.train.optimizer", "apply")}
PREFILL_SPANS = {"attention": ("repro_torch.models.layers", "attention")}


def _first(config: dict, keys: tuple[str, ...]):
    for key in keys:
        if key in config:
            return config[key]
    raise KeyError(f"the configuration has none of {keys}")


def arch_of(config: dict) -> dict:
    """The sizes the program and the reference take, from a configuration file."""
    arch = {name: _first(config, keys) for name, keys in ARCH_KEYS.items()}
    if config["port"]["family"] == "moe":
        arch.update({name: _first(config, keys) for name, keys in EXPERT_KEYS.items()})
        arch["capacity_factor"] = config["port"]["capacity_factor"]
    arch["head_dim"] = config.get("head_dim") or arch["d_model"] // arch["n_heads"]
    arch["mrope_sections"] = tuple((config.get("rope_scaling") or {}).get("mrope_section", ()))
    arch["family"] = config["port"]["family"]
    arch["name"] = config["name"]
    return arch


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list  # (name, unit, module) of the metrics this run reports

    @property
    def arch(self) -> dict:
        return arch_of(self.config)

    @property
    def aux_weight(self) -> float:
        """The weight of the MoE's load-balancing loss in the training loss."""
        return self.config.get("router_aux_loss_coef", 0.0)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.config["torch_dtype"]]


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no {what} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reported(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``traced`` the per-layer ones
    whose cells include it (or, with no list, that move a metric it reports),
    else the end-to-end ones whose cells include it."""
    def has(metric):
        return "workloads" not in metric or cell in metric["workloads"]
    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]


def load_cell(name: str, traced: bool = False, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark, with every file it names."""
    bench = _read_json(bench_path, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    config = _read_json(HERE / "configs" / f"{w['config']}.json", "configuration")
    mix = feed.validate(w["traffic"],
                           _read_json(TRAFFIC / f"{w['traffic']}.json", "traffic"))
    if config["mode"] != mix["kind"]:
        raise ValueError(f"{name}: configuration {w['config']} is for {config['mode']}, "
                         f"traffic {w['traffic']} is {mix['kind']}")
    limits = _read_json(HERE / "limits" / f"{name}.json", "limits")
    metrics = []
    for m in reported(bench, name, traced):
        module = load_metric(m["name"])
        if module.UNIT != m["unit"]:
            raise ValueError(f"metric {m['name']}: its reader gives {module.UNIT}, "
                             f"the benchmark says {m['unit']}")
        metrics.append((m["name"], m["unit"], module))
    return Cell(name, w["chips"], config, mix, limits, metrics)


def port_config(arch: dict):
    """The program's ArchConfig of ``arch``."""
    from repro_torch.configs.base import ArchConfig

    kw = dict(name=arch["name"], family=arch["family"], n_layers=arch["n_layers"],
              d_model=arch["d_model"], n_heads=arch["n_heads"], n_kv_heads=arch["n_kv_heads"],
              d_ff=arch["d_ff"], vocab=arch["vocab"], head_dim=arch["head_dim"],
              rope_theta=float(arch["rope_theta"]))
    if arch["family"] == "moe":
        kw.update(n_experts=arch["n_experts"], top_k=arch["top_k"],
                  capacity_factor=arch["capacity_factor"])
    if arch["mrope_sections"]:
        kw.update(rope_type="mrope", mrope_sections=arch["mrope_sections"])
    return ArchConfig(**kw)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """What the measured window did, for the metrics' readers."""
    kind: str
    arch: dict
    mix: dict
    dtype: str
    setup_s: float
    seconds: float = 0.0  # from the first batch's issue to the last one's completion
    units: int = 0  # steps or calls completed
    tokens: int = 0
    service: list = dataclasses.field(default_factory=list)  # s, issue to first token
    spans: dict = dataclasses.field(default_factory=dict)  # name -> device ms of each call
    trace: dict | None = None
    launches: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0


class Run:
    """One run of ``cell`` on ``device``: ``measure_train`` or ``measure_prefill``,
    then ``verify``."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool, device, t_start):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.device, self.t_start = torch.device(device), t_start
        self.arch = cell.arch
        self.feed = feed.Feed(cell.mix, self.arch["vocab"], bool(self.arch["mrope_sections"]),
                              seed, self.device)

    def make_weights(self):
        """The cell's weights for the run's seed: the same tensors at every call."""
        return weights.make(self.arch, self.seed, self.cell.dtype, self.device)

    # -- the window -------------------------------------------------------------

    def _profiled(self, spans: dict):
        """(spans, profiler) for a traced window, else nothing."""
        if not self.traced:
            return None, None
        from torch.profiler import ProfilerActivity, profile

        return trace.Spans(spans), profile(activities=[ProfilerActivity.CPU,
                                                       ProfilerActivity.CUDA])

    def _finish(self, window: Window, spans, prof) -> None:
        if prof is not None:
            window.spans = spans.ms()
            window.trace = trace.reduce(prof, "window", "step" if window.kind == "train"
                                        else "call", LABELS)
        from repro_torch.kernels import flash_attention as fa

        window.launches = dict(fa.launches_by_variant)

    def _reset_counters(self) -> None:
        from repro_torch.kernels import flash_attention as fa

        fa.launches = 0
        fa.launches_by_variant = dict.fromkeys(fa.SOURCES, 0)
        self.setup_peak = self._window_peak()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def _window_peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def setup_train(self):
        """(step, params, state) after the first steps, which the reference follows:
        their losses, the first gradient as AdamW took it (its first moment over
        1 - b1) and each leaf's change over them go to ``self.prog``."""
        from repro_torch.train import optimizer as opt
        from repro_torch.train.steps import TrainOptions, make_train_step

        self.ocfg = opt.AdamWConfig()
        step = make_train_step(port_config(self.arch), self.ocfg, TrainOptions(
            sync="auto", remat=True, use_kernel=True, moe_aux_weight=self.cell.aux_weight))
        params = self.make_weights()
        state = opt.init(params)
        self.prog = {"loss": [], "route": []}
        for i in range(self.cell.mix["first_steps"]):
            with _routing() as chosen:
                params, state, metrics = step(params, state, self.feed.batch(i))
            self.prog["loss"].append(float(metrics["loss"]))
            self.prog["route"].append(chosen[:self.arch["n_layers"]] if chosen else [])
            if i == 0:
                self.prog["grad"] = check.slice_norms(state.m, 1.0 / (1.0 - self.ocfg.b1))
        with torch.no_grad():
            self.prog["change"] = check.change_norms(params, self.make_weights())
        return step, params, state

    def measure_train(self) -> Window:
        step, params, state = self.setup_train()
        first = self.cell.mix["first_steps"]
        gc.collect()
        sync(self.device)
        window = Window("train", self.arch, self.cell.mix, self.cell.config["torch_dtype"],
                        time.perf_counter() - self.t_start)
        spans, prof = self._profiled(TRAIN_SPANS)
        self._reset_counters()
        with spans.active() if spans else nullcontext(), prof or nullcontext():
            with torch.profiler.record_function("window"):
                t0 = time.perf_counter()
                while True:
                    with torch.profiler.record_function("step"):
                        params, state, metrics = step(params, state,
                                                      self.feed.batch(first + window.units))
                        float(metrics["loss"])  # the host reads the step's loss: it has ended
                    window.units += 1
                    window.seconds = time.perf_counter() - t0
                    if window.seconds >= self.seconds:
                        break
        window.tokens = window.units * self.feed.tokens_per_batch
        window.peak_bytes = self._window_peak()
        self._finish(window, spans, prof)
        return window

    def setup_prefill(self) -> None:
        """The weights and the prefill step, warmed up on requests of the window's
        shape that the window does not send."""
        from repro_torch.train.steps import TrainOptions, make_prefill_step

        self.step = make_prefill_step(port_config(self.arch), TrainOptions(use_kernel=True))
        self.params = self.make_weights()
        for w in range(self.cell.mix["warmup_calls"]):
            self.serve(self.feed.batch(-1 - w))

    def serve(self, batch) -> torch.Tensor:
        """The first token of every row of ``batch``, on the host."""
        return self.step(self.params, batch)[:, -1].argmax(-1).cpu()

    def measure_prefill(self) -> Window:
        self.setup_prefill()
        mix = self.cell.mix
        gc.collect()
        sync(self.device)
        window = Window("prefill", self.arch, mix, self.cell.config["torch_dtype"],
                        time.perf_counter() - self.t_start)
        spans, prof = self._profiled(PREFILL_SPANS)
        self._reset_counters()
        self.served = []
        interval = 1.0 / mix["rate_per_s"]
        with spans.active() if spans else nullcontext(), prof or nullcontext():
            with torch.profiler.record_function("window"):
                t0 = time.perf_counter()
                end = t0 + self.seconds
                # calls due every interval; above capacity they queue, and none
                # is issued once the window's time is up
                while (due := t0 + window.units * interval) < end and time.perf_counter() < end:
                    while (now := time.perf_counter()) < due:
                        time.sleep(min(due - now, 0.01))
                    with torch.profiler.record_function("call"):
                        issued = time.perf_counter()
                        self.served.append(self.serve(self.feed.batch(window.units)))
                        window.service.append(time.perf_counter() - issued)
                    window.units += 1
                window.seconds = time.perf_counter() - t0
        window.tokens = window.units * self.feed.tokens_per_batch
        window.peak_bytes = self._window_peak()
        self._finish(window, spans, prof)
        return window

    def checked_rows(self, units: int) -> list[tuple[int, list[int]]]:
        """The served rows of a window of ``units`` calls that the reference
        recomputes, drawn from the seed: (call, its rows), in call order."""
        b = self.cell.mix["batch"]
        picks = random.Random(self.seed).sample(range(units * b),
                                                min(self.cell.mix["check_rows"], units * b))
        calls: dict[int, list[int]] = {}
        for p in sorted(picks):
            calls.setdefault(p // b, []).append(p % b)
        return list(calls.items())

    # -- the check --------------------------------------------------------------

    def verify(self, window: Window) -> dict[str, float]:
        """The compared numbers, from the reference run once the window has closed."""
        ref.no_tf32()
        prec = ref.Precision("fp32")
        if window.kind == "train":
            ocfg = dataclasses.asdict(self.ocfg)
            refs = check.train_reference(self.arch, self.make_weights, self.feed,
                                         self.cell.mix["first_steps"], ocfg,
                                         self.cell.aux_weight, prec, self.prog["route"])
            return check.train_numbers(self.prog, refs)
        picks = self.checked_rows(window.units)
        gaps = check.logit_gaps(self.arch, self.params,
                                [feed.rows(self.feed.batch(k), rows) for k, rows in picks],
                                [self.served[k][rows] for k, rows in picks], prec)
        return {"logit_gap": max(gaps)}


@contextmanager
def _routing():
    """The expert ids (G, T, k) of every ``moe._route`` call inside, in call
    order: a step's forward pass routes its MoE layers first, in layer order,
    before the backward pass runs them again."""
    from repro_torch.models import moe

    chosen, route = [], moe._route

    def recorded(*args, **kwargs):
        gates, experts, aux = route(*args, **kwargs)
        chosen.append(experts.detach().clone())
        return gates, experts, aux

    moe._route = recorded
    try:
        yield chosen
    finally:
        moe._route = route


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> dict:
    """One run; returns the result line's object, ``checks`` last."""
    r = Run(cell, seed, seconds, traced, device, t_start)
    window = r.measure_train() if cell.mix["kind"] == "train" else r.measure_prefill()
    dev = torch.device(device)
    peak = max(r.setup_peak, window.peak_bytes)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = r.verify(window)
    correct, checks = check.judge(numbers, cell.limits)
    metrics = {}
    for name, unit, module in cell.metrics:
        value = module.read(window)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window.units, "failed": 0, "metrics": metrics,
           "device": device_info}
    if window.trace is not None:
        device_info.update(busy_s=window.trace["busy_s"], window_s=window.trace["window_s"])
        out["breakdown"] = {"device_ops": window.trace["device_ops"],
                            "idle_gaps": window.trace["idle_gaps"]}
    out["checks"] = checks
    return out
