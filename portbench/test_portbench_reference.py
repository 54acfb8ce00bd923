"""The plain reference computes what the program computes, at smoke sizes of
both configurations: the forward pass (the MoE with pairs dropped at its
capacity, M-RoPE over an image grid), the loss, every gradient and one AdamW
step."""

import dataclasses

import pytest
import torch

from portbench import feed, harness, weights
from portbench.check import leaf_paths, tree_of
from portbench.reference import model as ref
from portbench.tiny import tiny
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt
from repro_torch.train import steps

CELLS = ["mixtral-train", "qwen2vl-train"]


def _setup(name, capacity_factor=None):
    cell = tiny(name)
    arch = cell.arch
    if capacity_factor is not None:
        arch["capacity_factor"] = capacity_factor
    params = weights.make(arch, 2**31 + 3, torch.float32, "cpu")
    batch = feed.Feed(cell.mix, arch["vocab"], bool(arch["mrope_sections"]), 5, "cpu").batch(0)
    return cell, arch, harness.port_config(arch), params, batch


@pytest.mark.parametrize("name", CELLS)
def test_forward_agrees(name):
    # a capacity of half the average load drops pairs in every group
    cell, arch, cfg, params, batch = _setup(name, capacity_factor=0.5)
    with torch.no_grad():
        logits, aux = transformer.forward(cfg, params, batch["tokens"], batch["positions"],
                                          remat=False, use_kernel=True)
        h, ref_aux = ref.hidden(arch, params, batch["tokens"], batch["positions"], ref.Precision())
    ref_logits = h @ params["unembed"]
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux, ref_aux, rtol=1e-5, atol=1e-6)
    if arch["family"] == "moe":  # the capacity did drop pairs
        x = torch.randn(64, arch["d_model"])
        _, _, keep, _, _ = ref.route(arch, x, params["layers"]["moe"]["router"][0])
        assert not keep.all()


@pytest.mark.parametrize("name", CELLS)
def test_loss_gradients_and_one_adamw_step_agree(name):
    cell, arch, cfg, params, batch = _setup(name, capacity_factor=0.5)
    options = steps.TrainOptions(remat=True, use_kernel=True, moe_aux_weight=cell.aux_weight)
    (total, (ce, _)), grads = steps.value_and_grad(steps.make_loss_fn(cfg, options))(params, batch)
    paths = list(leaf_paths(params))
    leaves = [p.detach().clone().requires_grad_(True) for _, p in paths]
    ref_params = tree_of((k, p) for (k, _), p in zip(paths, leaves))
    ref_total, ref_ce = ref.loss(arch, ref_params, batch, ref.Precision(), cell.aux_weight)
    ref_grads = torch.autograd.grad(ref_total, leaves)
    torch.testing.assert_close(total, ref_total.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ce, ref_ce.detach(), rtol=1e-5, atol=1e-6)
    for (key, g), rg in zip(leaf_paths(grads), ref_grads, strict=True):
        torch.testing.assert_close(g, rg, rtol=1e-3, atol=1e-5, msg=key)

    ocfg = opt.AdamWConfig(warmup_steps=1)
    state = opt.init(params)
    opt.apply(ocfg, state, params, grads)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    with torch.no_grad():
        ref.adamw(dataclasses.asdict(ocfg), leaves, list(ref_grads), m, v, 1)
    for (key, p), rp in zip(leaf_paths(params), leaves, strict=True):
        torch.testing.assert_close(p, rp.detach(), rtol=1e-4, atol=1e-6, msg=key)



def test_the_reference_takes_a_given_routing_and_reads_its_gap():
    """Its own choices given back change nothing and read a gap of 0; a token's
    second choice swapped for another expert is taken (the loss moves) and read
    as the drop of that expert's probability below the reference's own."""
    cell, arch, cfg, params, batch = _setup("mixtral-train", capacity_factor=0.5)
    with torch.no_grad():
        own = ref.Routing()
        _, ce = ref.loss(arch, params, batch, ref.Precision(), cell.aux_weight, own)
        again = ref.Routing([own.taken[i] for i in sorted(own.taken)])
        _, ce_again = ref.loss(arch, params, batch, ref.Precision(), cell.aux_weight, again)
        assert torch.equal(ce, ce_again) and again.gap == 0.0
        given = [t.clone() for t in again.given]
        first, second = given[0][0, 0].tolist()
        other = next(e for e in range(arch["n_experts"]) if e not in (first, second))
        given[0][0, 0, 1] = other
        swapped = ref.Routing(given)
        _, ce_swapped = ref.loss(arch, params, batch, ref.Precision(), cell.aux_weight, swapped)
    assert not torch.equal(ce, ce_swapped) and swapped.gap > 0.0
    assert torch.equal(swapped.taken[0], given[0])
