"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake tensors
(counterpart of ``repro.launch.dryrun``).

For each cell this script:
  1. builds the production mesh's layout (16×16 single-pod / 2×16×16
     multi-pod) as a ``TraceMesh``, which runs one rank in the calling thread
     and needs no peer;
  2. sums the at-rest blocks of rank 0 under ``param_specs``, ``batch_specs``
     and ``cache_specs`` (the JAX dry-run's ``argument_size_in_bytes``,
     exactly);
  3. traces the step that the port runs on rank 0 (``make_train_step``,
     ``make_prefill_step`` or ``make_decode_step`` on the rank's block of the
     batch, ``use_kernel=False``) on fake CPU tensors under
     ``FakeTensorMode``: nothing is allocated;
  4. records its FLOPs (``FlopCounterMode``), the bytes its aten ops read and
     write, the rank's peak of live storages, and the collectives it calls
     with their bytes on the wire, into a JSON report.

The port has no GSPMD.  In the cells that ``tensor_parallel.sharded`` admits
(every family's under its ``default_policy`` and ``--layout fsdp``) rank 0 runs
the sharded step (``parallel/tensor_parallel.py``) on its blocks under
``param_specs``: FSDP gathers over ``data`` a layer at a time and, under a
``tp=True`` policy, Megatron's column and row products over ``model`` (the MoE's
experts split on d_ff, the hybrid's recurrent layers on their Dr channels),
attention on whole heads (the pair or the gather route); under a ``tp=False``
one (whisper-tiny's and mamba2-130m's ``default_policy``, ``--layout fsdp``)
the layers run whole on the gathered weights.  In prefill and decode the logits of
the last position, in training (``sync="auto"``) the vocab-parallel loss and
the gradient route of ``make_tp_value_and_grad`` (the layers recomputed, every
collective's transpose), the gradients reduce-scattered over ``data``, and
AdamW on the rank's blocks and moments; ``auto_as`` records ``"tp"`` or
``"fsdp"``.  Every other cell (``moe_mode`` ``ep`` and ``gshard``, the sync
modes) runs the whole model on the rank's data shard,
as JAX's sync modes do, and ``sync="auto"`` there is traced as a psum of the
gradients (``auto_as`` ``"psum"``).  The FLOPs and collectives are the port's
own, not XLA's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out results/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_lib
from repro_torch.configs import (SHAPES, abstract_cache, abstract_params, get_config,
                                 input_specs, list_archs, valid_cells)
from repro_torch.core.comm import Comm, TraceMesh
from repro_torch.launch.mesh import production_layout
from repro_torch.models import get_model
from repro_torch.parallel import sharding as shard_lib
from repro_torch.parallel import tensor_parallel as tp_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib

P = shard_lib.P


def wire_bytes(kind: str, result_bytes: int, group: int) -> int:
    """Bytes a device puts on the wire for one collective, by the JAX dry-run's
    ring models: all-reduce 2(g-1)/g and all-gather (g-1)/g of the result,
    reduce-scatter (g-1) x the result, permute and all-to-all 1x."""
    if kind == "all-reduce":
        wire = 2 * result_bytes * max(0, group - 1) / max(1, group)
    elif kind == "all-gather":
        wire = result_bytes * max(0, group - 1) / max(1, group)
    elif kind == "reduce-scatter":
        wire = result_bytes * max(0, group - 1)
    else:  # collective-permute, all-to-all
        wire = result_bytes
    return int(wire)


def collective_stats(calls) -> dict:
    """{kind: {count, result_bytes, wire_bytes}} over ``(kind, result bytes,
    group size)`` calls: ``collective_stats`` of the JAX dry-run, over the
    calls a ``TraceMesh`` recorded instead of the lines of an HLO module."""
    stats: dict[str, dict] = {}
    for kind, nbytes, group in calls:
        rec = stats.setdefault(kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0})
        rec["count"] += 1
        rec["result_bytes"] += nbytes
        rec["wire_bytes"] += wire_bytes(kind, nbytes, group)
    return stats


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class _Tracker(TorchDispatchMode):
    """Bytes each aten op reads and writes, and the live storages' bytes.

    A storage counts from the op that first returns it until it is freed (a
    weak reference's callback), so views share their base's bytes, in-place
    ops add nothing, and what autograd or remat drops leaves the count.  Views,
    and queries that return no tensor, move no data and add no bytes accessed.
    """

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.bytes_accessed = 0
        self._seen: dict[int, weakref.ref] = {}

    def start(self, baseline: int = 0) -> None:
        """Count from here: the peak from what is live now plus ``baseline``."""
        self.live += baseline
        self.peak, self.bytes_accessed = self.live, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if outs and not func.is_view:  # not a view, nor a query (prim.device)
            ins = [t for t in pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._seen:
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                self._seen[key] = weakref.ref(st, lambda _, k=key, n=n: self._free(k, n))
        return out

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.pop(key, None)


def trace(make_args, step, untracked=lambda: (), baseline: int = 0) -> dict:
    """Run ``step(*make_args(), *untracked())`` on fake tensors.

    ``make_args`` builds the step's inputs inside ``FakeTensorMode`` (fake CPU
    tensors: shapes and dtypes, no storage), and their storages count as live;
    ``untracked`` builds inputs whose storages do not count (``baseline``
    bytes stand for them).  Returns the step's FLOPs (``FlopCounterMode``),
    ``bytes_accessed`` (the input and output bytes of every aten op it runs,
    unfused, views excepted: an upper bound, where XLA counts after fusion) and
    ``peak_bytes`` (the live storages at their highest, the inputs included).
    """
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        extra = untracked()
        with _Tracker() as tracker:
            args = make_args()
            tracker.start(baseline)
            with FlopCounterMode(display=False) as counter:
                step(*args, *extra)
            out = {"flops": counter.get_total_flops(),
                   "bytes_accessed": tracker.bytes_accessed,
                   "peak_bytes": tracker.peak}
            del args, extra
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


def _fake(tree):
    """Fake CPU tensors of the meta tree's shapes and dtypes (inside FakeTensorMode)."""
    return tree_lib.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree))


def _blocks(mesh, specs, tree):
    """Rank 0's blocks of the meta tensors of ``tree`` under ``specs`` (meta views)."""
    return shard_lib.block_views(tree, specs, mesh, 0)


@dataclasses.dataclass
class Cell:
    """A traced cell: its mesh and what rank 0 holds and runs."""

    mesh: TraceMesh
    per_rank_batch: int
    arg_bytes_per_device: int  # rank 0's at-rest blocks (JAX's argument_size_in_bytes)
    step_arg_bytes_per_rank: int  # what the port's rank holds to run the step
    make_args: object
    step: object
    untracked: object = lambda: ()
    baseline: int = 0
    auto_as: str | None = None  # a train cell's sync="auto": "psum", "tp" or "fsdp"


def _units(cfg):
    """(unit_layers, n_units) for layer-count extrapolation."""
    if cfg.family == "hybrid":
        period = max(1, cfg.attention_period)
        return period, cfg.n_layers // period
    return 1, cfg.n_layers


def build_cell(arch: str, shape_name: str, multi_pod: bool, options, smoke=False,
               cfg_override=None, layout: str = "2d", moe_mode: str = "tp",
               vocab_pad: int = 0) -> Cell:
    """The cell's ``TraceMesh``, its at-rest bytes and rank 0's step.

    Rank 0 takes its block of the batch under ``batch_specs``: the global batch
    over the data axes, or all of it where they do not divide it (JAX
    replicates it then).  A cell that ``tensor_parallel.sharded`` admits
    (training: under ``sync="auto"``) runs the sharded step on rank 0's blocks;
    every other cell the whole model."""
    cfg = cfg_override if cfg_override is not None else get_config(arch, smoke=smoke)
    if moe_mode != "tp" and cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_mode=moe_mode)
    if vocab_pad:
        cfg = dataclasses.replace(cfg, vocab_pad_to=vocab_pad)
    shape = SHAPES[shape_name]
    mesh = TraceMesh(*production_layout(multi_pod))
    policy = shard_lib.default_policy(cfg, multi_pod=multi_pod, layout=layout)
    params_abs = abstract_params(cfg)
    pspecs = shard_lib.sanitize_specs(params_abs, shard_lib.param_specs(cfg, params_abs, policy),
                                      mesh)
    bspecs = shard_lib.batch_specs(cfg, policy, mesh, shape.global_batch)
    batch_abs = input_specs(cfg, shape)
    block_abs = _blocks(mesh, {k: bspecs.get(k, P()) for k in batch_abs}, batch_abs)
    rows = block_abs["tokens"].shape[0]
    act_specs = shard_lib.activation_specs(cfg, policy, mesh, shape.global_batch)
    sharded = tp_lib.sharded(cfg, policy)
    opts = dataclasses.replace(options, use_kernel=False)
    param_bytes = _nbytes(_blocks(mesh, pspecs, params_abs))

    if shape.kind == "train":
        ocfg = opt_lib.AdamWConfig(schedule=cfg.schedule)
        # AdamW's state: the int32 step and two float32 moments under the
        # parameters' specs
        moment_abs = tree_lib.tree_map(
            lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"), params_abs)
        moment_bytes = 2 * _nbytes(_blocks(mesh, pspecs, moment_abs))
        at_rest = param_bytes + 4 + moment_bytes + _nbytes(block_abs)
        if sharded and opts.sync == "auto":
            return _tp_train_cell(cfg, ocfg, opts, mesh, params_abs, pspecs, block_abs, at_rest,
                                  {**act_specs, "policy": policy})
        # otherwise sync="auto" takes no mesh: its inter-rank meaning is the
        # data-parallel gradient all-reduce that XLA's auto mode inserts
        auto_as = None
        if opts.sync == "auto":
            opts, auto_as = dataclasses.replace(opts, sync="psum"), "psum"
        train_step = steps_lib.make_train_step(cfg, ocfg, opts, policy, mesh,
                                               act_specs=act_specs)

        def make_args():
            params = _fake(params_abs)
            return params, opt_lib.init(params)

        # the step slices the global batch into the ranks' shards (views);
        # rank 0 holds its block, which ``baseline`` stands for
        return Cell(mesh, rows, at_rest,
                    _nbytes(params_abs) + 4 + 2 * _nbytes(moment_abs) + _nbytes(block_abs),
                    make_args, train_step, untracked=lambda: (_fake(batch_abs),),
                    baseline=_nbytes(block_abs), auto_as=auto_as)

    def with_mesh(comm):
        return {**act_specs, "mesh": comm}

    if sharded:
        return _tp_serving_cell(cfg, shape, mesh, policy, opts, params_abs, pspecs,
                                block_abs, param_bytes, {**act_specs, "policy": policy})

    if shape.kind == "prefill":

        def prefill(params, batch):
            return mesh.run(lambda comm, p, b: steps_lib.make_prefill_step(
                cfg, opts, act_specs=with_mesh(comm))(p, b),
                [params] * mesh.size, [batch] * mesh.size)[0]

        return Cell(mesh, rows, param_bytes + _nbytes(block_abs),
                    _nbytes(params_abs) + _nbytes(block_abs),
                    lambda: (_fake(params_abs), _fake(block_abs)), prefill)

    # decode: the cache's blocks at rest (batch over data, heads over model);
    # the rank's step holds its rows of the cache with every head
    cache_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cspecs = shard_lib.cache_specs(cfg, cache_abs, policy, mesh, shape.global_batch)
    rank_cache = abstract_cache(cfg, rows, shape.seq_len)
    serve = steps_lib.make_decode_step(cfg)
    model = get_model(cfg)

    def make_args():
        return (_fake(params_abs),
                model.init_cache(cfg, rows, shape.seq_len, dtype=torch.bfloat16,
                                 device="cpu"),
                _fake(block_abs["tokens"]))

    def decode(params, cache, tokens):
        return mesh.run(lambda comm, p, c, t: serve(p, c, t), [params] * mesh.size,
                        [cache] * mesh.size, [tokens] * mesh.size)[0]

    return Cell(mesh, rows,
                param_bytes + _nbytes(_blocks(mesh, cspecs, cache_abs)) + _nbytes(block_abs),
                _nbytes(params_abs) + _nbytes(rank_cache) + _nbytes(block_abs),
                make_args, decode)


def _tp_train_cell(cfg, ocfg, opts, mesh, params_abs, pspecs, block_abs, at_rest,
                   act_specs) -> Cell:
    """Rank 0's sharded train step (``sync="auto"``) on its blocks, its moments
    (``optimizer.init`` of the blocks) and its rows: what it holds is its at-rest
    bytes."""
    blocks_abs = _blocks(mesh, pspecs, params_abs)
    step = steps_lib.make_train_step(cfg, ocfg, opts,
                                     act_specs={**act_specs, "mesh": Comm(mesh, 0)})

    def make_args():
        blocks = _fake(blocks_abs)
        return blocks, opt_lib.init(blocks), _fake(block_abs)

    return Cell(mesh, block_abs["tokens"].shape[0], at_rest, at_rest, make_args, step,
                auto_as="tp" if act_specs["policy"].tp else "fsdp")


def _tp_serving_cell(cfg, shape, mesh, policy, opts, params_abs, pspecs, block_abs,
                     param_bytes, act_specs) -> Cell:
    """Rank 0's sharded prefill or decode step on its blocks: the rank holds its
    blocks, its rows of the batch and (decode) its own cache."""
    blocks_abs = _blocks(mesh, pspecs, params_abs)
    comm = Comm(mesh, 0)
    act = {**act_specs, "mesh": comm}
    rows = block_abs["tokens"].shape[0]
    if shape.kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, opts, act_specs=act)
        return Cell(mesh, rows, param_bytes + _nbytes(block_abs), param_bytes + _nbytes(block_abs),
                    lambda: (_fake(blocks_abs), _fake(block_abs)), step)
    # decode: the cache's blocks at rest under cache_specs; the rank's step holds
    # its own cache (its rows and kv heads: tensor_parallel), of the same bytes
    # under the pair route
    cache_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cspecs = shard_lib.cache_specs(cfg, cache_abs, policy, mesh, shape.global_batch)
    serve = steps_lib.make_decode_step(cfg, act_specs=act)
    model = get_model(cfg)

    def make_cache():
        return model.init_cache(cfg, rows, shape.seq_len, dtype=torch.bfloat16, device="cpu",
                                act_specs=act)

    with FakeTensorMode():  # ``len`` an int32, as abstract_cache counts it
        rank_cache = _nbytes({k: v for k, v in make_cache().items() if k != "len"}) + 4
    return Cell(mesh, rows,
                param_bytes + _nbytes(_blocks(mesh, cspecs, cache_abs)) + _nbytes(block_abs),
                param_bytes + rank_cache + _nbytes(block_abs),
                lambda: (_fake(blocks_abs), make_cache(), _fake(block_abs["tokens"])), serve)


def _trace_cell(cell: Cell) -> dict:
    out = trace(cell.make_args, cell.step, cell.untracked, cell.baseline)
    stats = collective_stats((kind, n, g) for _, kind, n, g in cell.mesh.calls)
    out["collectives"] = stats
    out["collective_wire_bytes"] = sum(s["wire_bytes"] for s in stats.values())
    return out


def calibrate_cost(arch, shape_name, multi_pod, options, smoke=False, **variant) -> dict:
    """Trace the 1-unit and 2-unit depths and extrapolate linearly to the full
    depth, as the JAX dry-run does (XLA costs a while-loop body once).  The
    port has no scan, so where the layers divide into units the extrapolation
    equals the full trace; the hybrid's tail layers (38 = 12 × 3 + 2) are left
    out of both, as in JAX.  ``run_cell`` does not call it: its full-depth
    trace is already the exact count."""
    cfg = get_config(arch, smoke=smoke)
    unit, n_units = _units(cfg)
    vals = {}
    for k in (1, 2):
        sub = dataclasses.replace(cfg, n_layers=unit * k)
        t = _trace_cell(build_cell(arch, shape_name, multi_pod, options, smoke=smoke,
                                   cfg_override=sub, **variant))
        vals[k] = (t["flops"], t["bytes_accessed"], t["collective_wire_bytes"])
    out = {}
    for i, name in enumerate(("flops", "bytes_accessed", "collective_wire_bytes")):
        delta = vals[2][i] - vals[1][i]
        out[name + "_extrap"] = max(vals[1][i], vals[1][i] + delta * (n_units - 1))
    return out


def run_cell(arch, shape_name, multi_pod, options, smoke=False, variant_name="",
             **variant) -> dict:
    shape_cfg, _ = production_layout(multi_pod)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, shape_cfg)),
        "chips": math.prod(shape_cfg),
        "sync": options.sync,
        "variant": variant_name,
    }
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, multi_pod, options, smoke, **variant)
        if cell.auto_as:
            rec["auto_as"] = cell.auto_as
        t = _trace_cell(cell)
        rec.update({
            "ok": True,
            "trace_s": round(time.time() - t0, 1),
            "flops": t["flops"],
            "bytes_accessed": t["bytes_accessed"],
            "arg_bytes_per_device": cell.arg_bytes_per_device,
            "step_arg_bytes_per_rank": cell.step_arg_bytes_per_rank,
            "peak_bytes_per_rank": t["peak_bytes"],
            "collectives": t["collectives"],
            "collective_wire_bytes": t["collective_wire_bytes"],
            "per_rank_batch": cell.per_rank_batch,
        })
    except Exception as e:  # noqa: BLE001 — report and continue
        rec.update({
            "ok": False,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--sync", default="auto")
    ap.add_argument("--layout", default="2d", choices=["2d", "fsdp"])
    ap.add_argument("--moe", default="tp", choices=["tp", "ep", "gshard"])
    ap.add_argument("--pad-vocab", type=int, default=0)
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--variant", default="", help="label stored in the JSON")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    options = steps_lib.TrainOptions(sync=args.sync, ce_chunk=args.ce_chunk)

    results = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("sync", "auto"), r.get("variant", ""))
            for r in results if r.get("ok")}
    variant = dict(layout=args.layout, moe_mode=args.moe, vocab_pad=args.pad_vocab)

    for arch in archs:
        shapes = valid_cells(arch) if args.shape == "all" else args.shape.split(",")
        for shape_name in shapes:
            if shape_name not in valid_cells(arch):
                print(f"SKIP {arch} x {shape_name} (inapplicable)", flush=True)
                continue
            for multi_pod in meshes:
                key = (arch, shape_name, "2x16x16" if multi_pod else "16x16", args.sync,
                       args.variant)
                if key in done:
                    continue
                rec = run_cell(arch, shape_name, multi_pod, options, args.smoke,
                               variant_name=args.variant, **variant)
                status = "OK " if rec["ok"] else "FAIL"
                extra = (
                    f"flops={rec['flops']:.3e} peakGB/rank={rec['peak_bytes_per_rank']/1e9:.2f} "
                    f"coll={rec['collective_wire_bytes']/1e9:.2f}GB trace={rec['trace_s']}s"
                    if rec["ok"] else rec["error"][:160]
                )
                print(f"{status} {arch:22s} {shape_name:12s} {rec['mesh']:8s} {extra}",
                      flush=True)
                results.append(rec)
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    return results


if __name__ == "__main__":
    main()
