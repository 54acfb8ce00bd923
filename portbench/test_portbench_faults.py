"""A run with the timed path broken underneath comes out not correct, under the
cells' own limits: one fault at a time, each a fault the cell can have. And
the control, the reference in the next precision below the configuration's in
the program's place, comes out not correct too. All on the CPU at tiny sizes;
the harness's look for a card is left out (``harness.run`` on "cpu")."""

import time
from unittest import mock

import pytest
import torch

from portbench import check, harness
from portbench.reference import model as ref
from portbench.tiny import tiny
from repro_torch.models import moe
from repro_torch.train import optimizer as opt
from repro_torch.train import steps

SEED = 2**31 + 21


def _run(name, seconds=0.3, **mix):
    return harness.run(tiny(name, **mix), SEED, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["mixtral-train", "qwen2vl-train"])
def test_a_sound_training_run_is_correct(name):
    assert _run(name)["correct"]


def _unchanged(cfg, state, params, grads, norm_fn=opt.global_norm):
    """A step that returns its state unchanged."""
    return params, state, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}


def _half_batch(logits, labels):
    """Half of the batch left out, the mean taken over the rest."""
    half = logits.shape[0] // 2
    return torch.mean(steps._token_losses(logits[:half].float(), labels[:half]))


@pytest.mark.parametrize("name", ["mixtral-train", "qwen2vl-train"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(name, fault):
    target = ((opt, "apply", _unchanged) if fault == "unchanged"
              else (steps, "cross_entropy", _half_batch))
    with mock.patch.object(*target):
        out = _run(name)
    assert not out["correct"], out["checks"]


def test_an_expert_choice_altered_where_it_is_made_is_not_correct():
    """Each token's last choice goes to its least likely expert."""
    top_k = moe._top_k

    def altered(probs, k):
        experts = top_k(probs, k)
        return torch.cat([experts[..., :-1], probs.argmin(-1, keepdim=True)], -1)

    with mock.patch.object(moe, "_top_k", altered):
        out = _run("mixtral-train")
    assert not out["correct"] and out["checks"]["route_gap"]["value"] > 1e-3, out["checks"]


@pytest.mark.parametrize("name", ["qwen2vl-prefill"])
@pytest.mark.parametrize("fault", [None, "half_batch", "token"])
def test_a_broken_prefill_is_not_correct(name, fault):
    serve = harness.Run.serve

    def broken(self, batch):
        if fault == "token":  # one served token altered where it is produced
            out = serve(self, batch)
            out[0] = (out[0] + 1) % self.arch["vocab"]
            return out
        half = batch["tokens"].shape[0] // 2  # half the rows computed, served for all
        part = {k: (v[:, :half] if k == "positions" and v.dim() == 3 else v[:half])
                for k, v in batch.items()}
        return serve(self, part).repeat(2)

    with mock.patch.object(harness.Run, "serve", broken if fault else serve):
        out = _run(name, seconds=0.5, rate_per_s=40.0, check_rows=1000)
    assert out["correct"] == (fault is None), out["checks"]


@pytest.mark.parametrize("name", ["mixtral-train", "qwen2vl-train"])
def test_the_training_control_is_not_correct(name):
    """The reference with TF32 products in the program's place."""
    cell = tiny(name)
    r = harness.Run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    args = (r.arch, r.make_weights, r.feed, cell.mix["first_steps"],
            {**opt.AdamWConfig().__dict__}, cell.aux_weight)
    control = check.train_reference(*args, ref.Precision("tf32"))
    refs = check.train_reference(*args, ref.Precision("fp32"), control["route"])
    correct, checks = check.judge(check.train_numbers(control, refs), cell.limits)
    assert not correct, checks


def test_the_prefill_control_reads_above_the_program():
    """The reference in float8 in the program's place moves the served tokens
    further from the reference's best than the program does, over 16 requests.
    At these widths it need not pass the cell's limit: the card test below
    holds it there at the cell's size."""
    cell = tiny("qwen2vl-prefill")
    r = harness.Run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    r.setup_prefill()
    requests = [r.feed.batch(k) for k in range(16)]
    fp32 = ref.Precision("fp32")
    program = check.logit_gaps(r.arch, r.params, requests, [r.serve(b) for b in requests], fp32)
    control = check.logit_gaps(r.arch, r.params, requests, [None] * 16, fp32,
                               pick=ref.Precision("fp8"))
    assert max(control) > max(program)


@pytest.mark.card
@pytest.mark.parametrize("name", ["qwen2vl-prefill", "mixtral-train", "qwen2vl-train"])
def test_the_control_at_the_cells_size_is_not_correct(card, name):
    """control.py's readings on three seeds: the control, and for training the
    half batch, fail the cell's limits; the program passes them."""
    from portbench import control

    cell = harness.load_cell(name)
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        out = control.readings(harness, cell, seed, {"program", "control", "half_batch"}, card)
        assert check.judge(out["program"], cell.limits)[0], out
        assert not check.judge(out["control"], cell.limits)[0], out
        if "half_batch" in out:
            assert not check.judge(out["half_batch"], cell.limits)[0], out
    torch.cuda.empty_cache()
