"""The harness on the CPU: its loader, traffic, arithmetic and manifest."""

import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import feed, flops, harness, weights
from portbench.reference import model as ref
from portbench.tiny import tiny

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_the_files_it_names(name):
    for traced in (False, True):
        cell = harness.load_cell(name, traced)
        reported = [m for m, _, _ in cell.metrics]
        assert reported, name
        assert ("setup_s" in reported) != traced
    assert cell.mix["kind"] == cell.config["mode"]
    routed = {"route_gap"} if cell.arch.get("n_experts") else set()
    assert set(cell.limits) == ({"logit_gap"} if cell.mix["kind"] == "prefill"
                                else {"loss_gap", "grad_gap", "change_gap"} | routed)


def test_the_loader_refuses_unknown_names(tmp_path):
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        harness.load_metric("no_such_metric")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "no_such_mix"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError):
        harness.load_cell(bench["workloads"][0]["name"], bench_path=path)


def test_the_manifest_keeps_to_its_contract():
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(entry["name"]), entry["name"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert sorted(config["reduced"]) == sorted(c["reduced"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:  # a cell a per-layer metric lists reports what it moves
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


MIXES = sorted(p.stem for p in (ROOT / "portbench" / "traffic").glob("*.json"))


@pytest.mark.parametrize("name", MIXES)
def test_the_same_seed_gives_the_same_inputs(name):
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json").read_text())
    mix.update(seq=64, segments=[s for s in mix["segments"] if "text" in s])
    a, b, c = (feed.Feed(mix, 1000, True, seed, "cpu") for seed in (2**31 + 5, 2**31 + 5, 7))
    for i in (0, 1, -1):
        for key, value in a.batch(i).items():
            assert torch.equal(value, b.batch(i)[key])
        assert not torch.equal(a.batch(i)["tokens"], c.batch(i)["tokens"])
    assert not torch.equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    tokens = a.batch(0)["tokens"]
    assert len({tuple(row.tolist()) for row in tokens}) == tokens.shape[0]  # rows all differ


def test_a_mix_names_the_ids_its_prompts_are_drawn_from(tmp_path):
    """A mix of another token distribution is one new file: here prompts drawn
    from 16 ids that the seed picks, loaded by name like any other mix."""
    bench = json.loads(json.dumps(BENCH))
    cell = next(w for w in bench["workloads"] if w["name"] == "qwen2vl-prefill")
    base = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "pool16.json").write_text(json.dumps({**base, "token_pool": 16}))
    cell["traffic"] = "pool16"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with mock.patch.object(harness, "TRAFFIC", tmp_path / "traffic"):
        loaded = harness.load_cell("qwen2vl-prefill", bench_path=tmp_path / "BENCHMARK.json")
    mix = {**loaded.mix, "seq": 64, "segments": []}
    a, b, c = (feed.Feed(mix, 1000, False, seed, "cpu") for seed in (2**31 + 5, 2**31 + 5, 7))
    ids = torch.cat([a.batch(i)["tokens"] for i in range(4)])
    assert len(ids.unique()) == 16 and torch.equal(ids, torch.cat([b.batch(i)["tokens"]
                                                                    for i in range(4)]))
    assert not torch.equal(a.pool.sort().values, c.pool.sort().values)
    uniform = feed.Feed({k: v for k, v in mix.items() if k != "token_pool"}, 1000, False,
                        2**31 + 5, "cpu")
    assert len(torch.cat([uniform.batch(i)["tokens"] for i in range(4)]).unique()) > 16
    with pytest.raises(ValueError):
        feed.Feed({**mix, "token_pool": 1001}, 1000, False, 1, "cpu")
    with pytest.raises(ValueError):
        feed.validate("pool0", {**base, "token_pool": 0})


def test_a_mix_with_a_missing_count_is_refused():
    base = json.loads((ROOT / "portbench" / "traffic" / "train_2x2048.json").read_text())
    feed.validate("train", base)
    for key in ("batch", "seq", "first_steps"):
        with pytest.raises(ValueError):
            feed.validate("train", {k: v for k, v in base.items() if k != key})
    with pytest.raises(ValueError):
        feed.validate("prefill", {**base, "kind": "prefill"})  # no rate, no check_rows


def test_image_grid_positions_are_qwen2_vls():
    mix = {"seq": 12, "segments": [{"text": 2}, {"image": [1, 2, 3]}]}
    pos = feed.positions(mix, mrope=True)
    # text 0, 1; the image's 6 tokens from 2: t fixed, h over 2 rows, w over 3 columns;
    # then text from one past the largest position, 2 + 2 = 4
    assert pos.tolist() == [[0, 1, 2, 2, 2, 2, 2, 2, 5, 6, 7, 8],
                            [0, 1, 2, 2, 2, 3, 3, 3, 5, 6, 7, 8],
                            [0, 1, 2, 3, 4, 2, 3, 4, 5, 6, 7, 8]]
    assert feed.positions(mix, mrope=False).tolist() == pos[0].tolist()
    mix_name = next(w["traffic"] for w in BENCH["workloads"] if w["name"] == "qwen2vl-prefill")
    real = json.loads((ROOT / "portbench" / "traffic" / f"{mix_name}.json").read_text())
    pos = feed.positions(real, mrope=True)
    assert pos.shape == (3, 4096)
    image = pos[:, 32:32 + 48 * 48]
    assert image[0].unique().tolist() == [32] and image[1].max() == image[2].max() == 32 + 47
    assert pos[:, 32 + 48 * 48].tolist() == [80, 80, 80]


@pytest.mark.parametrize("name", ["mixtral-train", "qwen2vl-prefill"])
def test_flop_counts_agree_with_the_references_products(name):
    cell = tiny(name)
    arch = cell.arch
    if arch["family"] == "moe":
        arch["capacity_factor"] = float(arch["n_experts"])  # no pair dropped: every product runs
    b, s = 2, 64
    params = weights.make(arch, 1, torch.float32, "cpu")
    tokens = torch.randint(0, arch["vocab"], (b, s))
    pos = feed.Feed(cell.mix, arch["vocab"], bool(arch["mrope_sections"]), 1, "cpu").positions
    with FlopCounterMode(display=False) as counter:
        ref.last_logits(arch, params, tokens, pos, ref.Precision())
    # the reference computes every (q, k) pair and masks; the yardstick counts causal pairs
    expected = flops.forward_flops(arch, b, s, unembed_rows=b, causal=False)
    assert counter.get_total_flops() == expected
    assert flops.prefill_flops(arch, b, s) == expected - (
        flops.attention_flops(arch, b, s, causal=False) - flops.attention_flops(arch, b, s))
    assert flops.train_step_flops(arch, b, s) == 3 * flops.forward_flops(arch, b, s, b * s)


def test_flash_bound_picks_the_longer_of_operations_and_bytes():
    # Mixtral's training shape in fp32: operations at the TF32 peak bound it
    b, s, h, kv, hd = 2, 2048, 32, 8, 128
    assert flops.flash_bound_s(b, s, h, kv, hd, "float32") == pytest.approx(
        4 * b * h * hd * s * (s + 1) / 2 / 495e12)
    # one row of one token: the bytes bound it
    assert flops.flash_bound_s(1, 1, 1, 1, 128, "bfloat16") == pytest.approx(
        4 * 128 * 2 / 3.35e12)


def _window(kind, **kw):
    w = harness.Window(kind, {}, {"batch": 2, "seq": 8}, "float32", 1.0)
    for k, v in kw.items():
        setattr(w, k, v)
    return w


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_the_rate_counts_a_stall_inside_the_window(kind):
    rate = harness.load_metric(f"{kind}_tokens_per_s")
    # 10 steps or calls of 16 tokens in a window of 2 s, or 4 s with a 2 s stall in it
    assert rate.read(_window(kind, tokens=160, units=10, seconds=2.0)) == 80.0
    assert rate.read(_window(kind, tokens=160, units=10, seconds=4.0)) == 40.0
    other = "prefill" if kind == "train" else "train"
    assert rate.read(_window(other, tokens=160, units=10, seconds=2.0)) is None


def test_the_spread_is_the_quartile_distance_over_the_median():
    from portbench import spread

    values = [10.0, 10.1, 9.9, 10.2, 9.8, 10.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread.spread(values) == pytest.approx((q3 - q1) / 10.0)


def test_a_run_without_a_card_exits_with_no_result(tmp_path):
    """Without a CUDA device run.py refuses before any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          CELLS[0], "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


@pytest.mark.card
def test_a_short_run_on_the_card_is_correct(card):
    torch.cuda.empty_cache()  # the run's process has the card to itself
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "qwen2vl-prefill", "--seed", str(2**31 + 11), "--seconds", "5",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]


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


def test_the_trace_reduction_counts_busy_time_and_labels_gaps():
    from types import SimpleNamespace

    from portbench import trace

    host = [("window", 0, 1000), ("call", 100, 400), ("call", 600, 900), ("moe", 200, 300)]
    device = [("gemm", 100, 200), ("gemm", 150, 250), ("flash_fwd_sm90", 260, 400),
              ("gemm", 600, 700), ("call", 100, 400)]  # the last: the range's device copy
    events = [_Event(n, a, b, False) for n, a, b in host] + [_Event(n, a, b, True)
                                                             for n, a, b in device]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    t = trace.reduce(prof, "window", "call", ("moe", "call", "window"))
    assert t["window_s"] == 1000e-9 and t["units"] == 2
    assert t["busy_s"] == pytest.approx((150 + 140 + 100) * 1e-9)
    assert t["unit_busy_s"] == pytest.approx(t["busy_s"]) and t["unit_s"] == 600e-9
    assert t["kernels"]["gemm"] == (pytest.approx(300e-9), 3)
    # the gap 250-260 lies inside a call, under "moe"; 400-600 lies between calls
    assert t["idle_gaps"] == [["moe", pytest.approx(10e-9)]]
    assert t["device_ops"][0][0] == "gemm"
