"""The dry-run's trace against real steps of the port, on the CPU.

* A fake-tensor trace of a smoke train step counts the FLOPs
  (``FlopCounterMode``), the bytes and the peak of live storages that the same
  step counts on real CPU tensors.
* ``calibrate_cost``'s extrapolation equals the full trace (the port has no
  scan); the hybrid's equals the trace of its whole units, as in JAX.
* ``run_cell``'s record and the CLI's JSON.
* qwen2-vl-7b's prefill and train step trace on fake tensors (M-RoPE's band
  index is built from Python ints), and its sync train step shards the
  (3, B, S) positions on their batch axis.
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import abstract_params, get_config  # noqa: E402
from repro_torch.core.comm import LocalMesh  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.parallel.sharding import Policy  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import steps as st  # noqa: E402


# ---------------------------------------------------------------------------
# the trace against a run on real tensors
# ---------------------------------------------------------------------------


def _step_and_args(arch, rows=2, seq=64):
    cfg = get_config(arch, smoke=True)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=2, schedule=cfg.schedule)
    step = st.make_train_step(cfg, ocfg, st.TrainOptions(remat=True))
    host = {k: torch.from_numpy(v) for k, v in make_batch(cfg, seq, rows).items()}
    return cfg, step, host


@pytest.mark.parametrize("arch", ["llama3.2-3b", "moonshot-v1-16b-a3b", "mamba2-130m",
                                  "recurrentgemma-9b", "qwen2-vl-7b", "whisper-tiny"])
def test_fake_trace_counts_what_a_real_step_counts(arch):
    from torch.utils.flop_counter import FlopCounterMode

    cfg, step, host = _step_and_args(arch)
    params_abs = abstract_params(cfg, dtype=torch.float32)
    spec = {k: (tuple(v.shape), v.dtype) for k, v in host.items()}

    def make_args():
        params = dryrun._fake(params_abs)
        return params, opt.init(params), {k: torch.empty(s, dtype=d) for k, (s, d) in spec.items()}

    pred = dryrun.trace(make_args, step)
    tracker = dryrun._Tracker()
    with tracker:
        params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0),
                                            dtype=torch.float32)
        state, batch = opt.init(params), {k: v.clone() for k, v in host.items()}
        tracker.start()
        with FlopCounterMode(display=False) as counter:
            step(params, state, batch)
    assert pred["flops"] == counter.get_total_flops() > 0
    if cfg.family == "moe":
        # eager one_hot on CPU tensors checks its input (aminmax) and scatters
        # into int64 zeros, where fake tensors compare with an arange: a few
        # KB of the routing's bytes differ, no FLOP
        assert pred["bytes_accessed"] == pytest.approx(tracker.bytes_accessed, rel=1e-3)
        assert pred["peak_bytes"] == pytest.approx(tracker.peak, rel=1e-3)
    else:
        assert pred["bytes_accessed"] == tracker.bytes_accessed
        assert pred["peak_bytes"] == tracker.peak


@pytest.mark.parametrize("arch,shape", [("llama3.2-3b", "train_4k"),
                                        ("moonshot-v1-16b-a3b", "train_4k"),
                                        ("mamba2-130m", "decode_32k"),
                                        ("whisper-tiny", "decode_32k"),
                                        ("recurrentgemma-9b", "train_4k")])
def test_calibrate_extrapolation_equals_the_full_trace(arch, shape):
    opts = st.TrainOptions()
    got = dryrun.calibrate_cost(arch, shape, False, opts, smoke=True)
    cfg = get_config(arch, smoke=True)
    unit, n_units = dryrun._units(cfg)
    # the hybrid's tail layers are in neither (as in JAX): hold it to its units
    full = dryrun._trace_cell(dryrun.build_cell(
        arch, shape, False, opts, smoke=True,
        cfg_override=dataclasses.replace(cfg, n_layers=unit * n_units)))
    assert got == {f"{k}_extrap": full[k] for k in ("flops", "bytes_accessed",
                                                     "collective_wire_bytes")}
    assert (cfg.n_layers == unit * n_units) == (cfg.family != "hybrid")


def test_run_cell_record_keys():
    # moe_mode="gshard" takes the sharded step: the smoke arch's default_policy
    # is tp=False (d_model < 1024), so FSDP over data with every expert whole on
    # the rank; no all-reduce of the whole model's gradient (the psum route's)
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", "train_4k", False, st.TrainOptions(),
                          smoke=True, moe_mode="gshard")
    assert rec["ok"], rec.get("error")
    assert rec["sync"] == "auto" and rec["auto_as"] == "fsdp"
    assert (rec["mesh"], rec["chips"], rec["per_rank_batch"]) == ("16x16", 256, 16)
    cfg = get_config("moonshot-v1-16b-a3b-smoke")
    n = sum(t.numel() for t in tree_lib.leaves(abstract_params(cfg)))
    assert set(rec["collectives"]) == {"all-gather", "all-reduce", "reduce-scatter"}
    assert rec["collectives"]["all-reduce"]["result_bytes"] < 4 * n
    assert rec["arg_bytes_per_device"] == rec["step_arg_bytes_per_rank"]
    assert rec["collective_wire_bytes"] == sum(c["wire_bytes"] for c in rec["collectives"].values())
    assert rec["step_arg_bytes_per_rank"] < rec["peak_bytes_per_rank"]
    # moe_mode="ep" cuts the experts over model: 8 over 16 ranks raises, recorded
    rec = dryrun.run_cell("moonshot-v1-16b-a3b", "train_4k", False, st.TrainOptions(),
                          smoke=True, moe_mode="ep")
    assert not rec["ok"] and "8 does not divide by 16" in rec["error"]


def test_roofline_terms_read_the_full_trace():
    """The hybrid's record counts its tail layers, which the calibration's
    whole units leave out, and the roofline twin reads the record's counts."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks import roofline_torch as roof

    opts = st.TrainOptions()
    rec = dryrun.run_cell("recurrentgemma-9b", "train_4k", False, opts, smoke=True)
    assert rec["ok"], rec.get("error")
    assert not any(k.endswith("_extrap") for k in rec)
    a = roof.analyse(rec)
    assert a["t_compute"] == rec["flops"] / roof.PEAK_FLOPS
    assert a["t_memory"] == rec["bytes_accessed"] / roof.HBM_BW
    assert a["t_collective"] == rec["collective_wire_bytes"] / roof.LINK_BW
    units = dryrun.calibrate_cost("recurrentgemma-9b", "train_4k", False, opts, smoke=True)
    assert rec["flops"] > units["flops_extrap"]


def test_data_shard_cuts_each_leaf_where_batch_specs_put_the_data_axis():
    from repro_torch.core.comm import TraceMesh
    from repro_torch.parallel import sharding as sh

    shapes = {"tokens": (8, 5), "labels": (8, 5), "positions": (3, 8, 5),
              "encoder_frames": (8, 5, 3)}
    for arch in ("qwen2-vl-7b", "whisper-tiny", "llama3.2-3b"):
        cfg = get_config(arch, smoke=True)
        mesh = TraceMesh((4, 2), ("data", "model"))
        specs = sh.batch_specs(cfg, sh.default_policy(cfg), mesh, 8)
        for k, spec in specs.items():
            assert [i for i, ax in enumerate(spec) if ax is not None] == [sh.batch_axis(k)]
        batch = {k: torch.arange(math.prod(shapes[k])).reshape(shapes[k]) for k in specs}
        shard = st._data_shard(batch, 1, 4)
        for k, v in batch.items():
            assert torch.equal(shard[k], v.narrow(sh.batch_axis(k), 2, 2))


def test_main_writes_the_json(tmp_path):
    out = tmp_path / "dryrun_torch.json"
    recs = dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k,long_500k", "--mesh",
                        "multi", "--smoke", "--out", str(out)])
    assert [r["ok"] for r in recs] == [True]
    with open(out) as f:
        assert json.load(f)[0]["mesh"] == "2x16x16"


# ---------------------------------------------------------------------------
# the VLM: M-RoPE on fake tensors, the sync step's positions
# ---------------------------------------------------------------------------


def test_vlm_prefill_and_train_step_trace_on_fake_tensors():
    cfg, step, host = _step_and_args("qwen2-vl-7b")
    assert "positions" in host
    params_abs = abstract_params(cfg, dtype=torch.float32)
    spec = {k: (tuple(v.shape), v.dtype) for k, v in host.items()}
    prefill = st.make_prefill_step(cfg, st.TrainOptions())

    def make_args():
        params = dryrun._fake(params_abs)
        return params, opt.init(params), {k: torch.empty(s, dtype=d) for k, (s, d) in spec.items()}

    assert dryrun.trace(make_args, step)["flops"] > 0
    out = dryrun.trace(lambda: make_args()[::2], prefill)
    assert out["flops"] > 0


def test_vlm_sync_step_shards_positions_on_the_batch_axis():
    cfg, _, host = _step_and_args("qwen2-vl-7b", rows=4, seq=16)
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    gen = torch.Generator().manual_seed(0)
    params = get_model(cfg).init_params(cfg, gen, dtype=torch.float32)
    results = []
    for opts, mesh in ((st.TrainOptions(sync="auto"), None),
                       (st.TrainOptions(sync="psum"), LocalMesh((4,), ("data",), "cpu"))):
        p = tree_lib.tree_map(torch.clone, params)
        step = st.make_train_step(cfg, ocfg, opts, Policy(data_axes=("data",)), mesh)
        p, _, m = step(p, opt.init(p), host)
        results.append((float(m["loss"]), p))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-5)
    for a, b in zip(tree_lib.leaves(results[0][1]), tree_lib.leaves(results[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
