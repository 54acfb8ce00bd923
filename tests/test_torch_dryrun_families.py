"""The dry-run's cells of the MoE, VLM and audio families trace rank 0's sharded
step (``parallel/tensor_parallel.py``), and ``TraceMesh`` counts the collectives
that a ``LocalMesh`` run of the same step calls.

* moonshot-v1-16b-a3b-smoke and qwen2-vl-7b-smoke under a ``tp=True`` policy
  (their full-width twins' ``default_policy``; the smoke archs' has none),
  whisper-tiny-smoke under its own ``default_policy`` (``tp=False``): the
  train_4k, prefill_32k and decode_32k cells take the sharded step, ``auto_as``
  ``"tp"`` or ``"fsdp"``, the rank holding its at-rest bytes.
* llama3.2-3b-smoke's train_4k record under its ``default_policy``: FSDP's
  gathers, their transposes and its psums counted.
* The prefill, decode and train steps of the three on 2 x 4, rank 0 traced on
  fake tensors over a ``TraceMesh``, against rank 0 of a ``LocalMesh`` run:
  every collective's calls, input bytes and the bytes sent to each peer.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import abstract_params, get_config  # noqa: E402
from repro_torch.core.comm import Comm, LocalMesh, TraceMesh  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

torch.set_num_threads(1)

AXES = ("data", "model")
SEQ, MAX_LEN, BATCH, SHAPE = 8, 7, 4, (2, 4)
# arch: whether its cells take a tp=True policy
ARCHS = {"moonshot-v1-16b-a3b": True, "qwen2-vl-7b": True, "whisper-tiny": False}


def _policy(arch):
    cfg = get_config(arch, smoke=True)
    return sh.Policy() if ARCHS[arch] else sh.default_policy(cfg)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_dryrun_cell_traces_the_sharded_step(arch, shape, monkeypatch):
    if ARCHS[arch]:  # the full-width twin's default_policy
        monkeypatch.setattr(sh, "default_policy", lambda cfg, **_: sh.Policy())
    cell = dryrun.build_cell(arch, shape, False, TS.TrainOptions(), smoke=True)
    rec = dryrun._trace_cell(cell)
    calls = {k: v["count"] for k, v in rec["collectives"].items()}
    cfg = get_config(arch, smoke=True)
    if shape == "train_4k":
        assert cell.auto_as == ("tp" if ARCHS[arch] else "fsdp")
        # the rank holds its blocks, its moments, the step and its rows
        assert cell.step_arg_bytes_per_rank == cell.arg_bytes_per_device
    # FSDP: every layer's weights gathered over data (16 ranks) as it runs
    assert calls["all-gather"] >= 4 * cfg.n_layers
    if ARCHS[arch]:  # the row sums over model: attention's and the MLP's or experts'
        assert calls["reduce-scatter"] >= 2 * cfg.n_layers
    else:  # nothing is exchanged over model: no row sum, no head exchange
        assert "all-to-all" not in calls
        assert ("reduce-scatter" in calls) == (shape == "train_4k")  # FSDP's transposes
    assert rec["peak_bytes"] >= cell.step_arg_bytes_per_rank > 0 and rec["flops"] > 0


def test_run_cell_record_of_the_fsdp_step():
    """llama3.2-3b-smoke's ``default_policy`` has ``tp=False``: its train_4k cell
    runs rank 0's sharded step with FSDP over ``data`` alone (``auto_as``
    "fsdp"), and the record counts its gathers, their transposes and its psums."""
    rec = dryrun.run_cell("llama3.2-3b", "train_4k", False, TS.TrainOptions(), smoke=True)
    assert rec["ok"], rec.get("error")
    assert rec["sync"] == "auto" and rec["auto_as"] == "fsdp"
    assert (rec["mesh"], rec["chips"], rec["per_rank_batch"]) == ("16x16", 256, 16)
    cfg = get_config("llama3.2-3b-smoke")
    params = abstract_params(cfg)
    n = cfg.n_layers
    layer = sum(t.numel() for k, t in params["layers"].items() if k.startswith("w")) // n
    top = params["embed"].numel()
    calls = rec["collectives"]
    # a layer's 7 weights all-gathered over data (bf16), forward and recomputed,
    # the embed twice and the unembed once; their transposes once
    assert calls["all-gather"]["count"] == 2 * 7 * n + 3
    assert calls["all-gather"]["result_bytes"] == 2 * (2 * n * layer + 3 * top)
    assert calls["reduce-scatter"]["count"] == 7 * n + 2
    # the loss's mean over data, the 3 norm scales summed over data, the norm's psum
    assert calls["all-reduce"]["count"] == 5
    assert rec["collective_wire_bytes"] == sum(c["wire_bytes"] for c in calls.values())
    assert rec["step_arg_bytes_per_rank"] == rec["arg_bytes_per_device"]
    assert rec["step_arg_bytes_per_rank"] < rec["peak_bytes_per_rank"]


def _step(arch, kind, comm, rows):
    cfg = get_config(arch, smoke=True)
    act = {"mesh": comm, "policy": _policy(arch)}
    if kind == "prefill":
        return lambda p, b: TS.make_prefill_step(cfg, TS.TrainOptions(), act_specs=act)(p, b)
    if kind == "decode":
        def decode(p, b):
            cache = TT.init_cache(cfg, rows, MAX_LEN, dtype=torch.float32, act_specs=act)
            return TS.make_decode_step(cfg, act_specs=act)(p, cache, b["tokens"][:, :1])
        return decode
    step = TS.make_train_step(cfg, opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4),
                              TS.TrainOptions(), act_specs=act)
    return lambda p, b: step(p, opt.init(p), b)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_trace_mesh_counts_what_local_mesh_counts(arch, kind):
    """Rank 0's sharded step traced on fake tensors over a 2 x 4 ``TraceMesh`` calls
    the collectives, and sends the bytes, that each rank of a ``LocalMesh`` run
    does."""
    cfg = get_config(arch, smoke=True)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, SEQ, BATCH).items()}
    if kind != "train":
        batch.pop("labels")
    policy = _policy(arch)
    dp = SHAPE[0]
    rows = BATCH // dp

    def rank_rows(b, i):
        return {k: v.narrow(sh.batch_axis(k), i * rows, rows) for k, v in b.items()}

    local = LocalMesh(SHAPE, AXES, "cpu", timeout=60.0)
    specs = sh.sanitize_specs(params, sh.param_specs(cfg, params, policy), local)
    local.run(lambda c: _step(arch, kind, c, rows)(
        tree_lib.tree_map(torch.clone, sh.block_views(params, specs, local, c.rank)),
        rank_rows(batch, c.axis_index("data"))))
    trace = TraceMesh(SHAPE, AXES)
    meta = tree_lib.tree_map(lambda t: t.to("meta"), sh.block_views(params, specs, trace, 0))
    spec = {k: (tuple(v.shape), v.dtype) for k, v in rank_rows(batch, 0).items()}
    dryrun.trace(lambda: (dryrun._fake(meta), {k: torch.zeros(s, dtype=d)
                                               for k, (s, d) in spec.items()}),
                 _step(arch, kind, Comm(trace, 0), rows))
    for name in ("psum_calls", "all_gather_calls", "all_to_all_calls", "reduce_scatter_calls"):
        assert getattr(local.stats, name) == local.size * getattr(trace.stats, name), name
    assert {k: v for k, v in local.stats.bytes.items() if k[0] == 0} == dict(trace.stats.bytes)
    assert {k: v // local.size for k, v in local.stats.payload.items()} == dict(
        trace.stats.payload)
    assert trace.stats.all_gather_calls > 0
