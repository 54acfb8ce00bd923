"""What decides ``correct``: the program's outputs of the timed path against the
plain reference on the same weights and inputs.

Training: the reference follows the program's first steps from the same
weights and batches. Compared are each step's cross-entropy (relative gap),
the norm of the first step's gradient as the optimizer takes it (clipped) of
every leaf, a stacked layer leaf taken a layer at a time, and the norm of each
leaf's change over the first steps. A leaf's gap is the difference of the two
norms over the larger of the reference's norm of that leaf and of the median
leaf. Leaves whose reference gradient is under a thousandth of the median
leaf's move by rounding alone, and are left out of the change. Where the model
routes tokens to experts, the reference takes the judged side's routing
choices, and ``route_gap`` is the widest by which a choice's probability lies
below that of the reference's own choice at its rank.

Prefill: for each sampled request of the window, by how much the reference's
logit of the token the program served lies below the reference's largest.
"""

from __future__ import annotations

import statistics

import torch

from portbench.reference import model as ref
from portbench.weights import named_slices

QUIET_GRADIENT = 1e-3  # of the median leaf's reference gradient


def slice_norms(tree: dict, scale: float = 1.0) -> dict[str, float]:
    return {name: float(t.float().norm()) * scale for name, t in named_slices(tree)}


def change_norms(after: dict, before: dict) -> dict[str, float]:
    b = dict(named_slices(before))
    return {name: float((t.float() - b[name].float()).norm()) for name, t in named_slices(after)}


def leaf_paths(tree: dict, prefix: str = ""):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from leaf_paths(tree[key], f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", tree[key]


def tree_of(pairs) -> dict:
    out: dict = {}
    for path, value in pairs:
        node = out
        *inner, last = path.split(".")
        for key in inner:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def train_reference(arch: dict, make_weights, feed, steps: int, ocfg: dict, aux_weight: float,
                    prec: ref.Precision, follow: list | None = None) -> dict:
    """The reference's readings over the first ``steps`` steps: cross-entropy of
    each, the first step's clipped gradient norms, each leaf's change, and its
    routing choices of each step (``route``: a list a MoE layer, empty without
    experts). With ``follow``, another side's ``route``, it takes those choices
    and reads ``route_gap``."""
    params = make_weights()
    paths, leaves = zip(*leaf_paths(params))
    for p in leaves:
        p.requires_grad_(True)
    m = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    v = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    out = {"loss": [], "route": []}
    gap = 0.0
    for i in range(steps):
        routing = ref.Routing(follow[i] if follow else None)
        total, ce = ref.loss(arch, params, feed.batch(i), prec, aux_weight, routing)
        out["route"].append([routing.taken[k] for k in sorted(routing.taken)])
        gap = max(gap, routing.gap)
        grads = torch.autograd.grad(total, leaves)
        with torch.no_grad():
            clipped = ref.adamw(ocfg, list(leaves), list(grads), m, v, i + 1)
        out["loss"].append(float(ce.detach()))
        if i == 0:
            out["grad"] = slice_norms(tree_of(zip(paths, clipped)))
        del total, ce, grads, clipped
    del m, v
    with torch.no_grad():
        out["change"] = change_norms(params, make_weights())
    if follow and any(follow):
        out["route_gap"] = gap
    return out


def _worst(prog: dict[str, float], refs: dict[str, float], names) -> float:
    median = statistics.median(refs.values())
    return max(abs(prog[n] - refs[n]) / max(refs[n], median) for n in names)


def train_numbers(prog: dict, refs: dict) -> dict[str, float]:
    """The compared numbers of a training cell from the two sides' readings."""
    median_grad = statistics.median(refs["grad"].values())
    moving = [n for n, g in refs["grad"].items() if g >= QUIET_GRADIENT * median_grad]
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], refs["loss"],
                                                           strict=True)),
        "grad_gap": _worst(prog["grad"], refs["grad"], refs["grad"]),
        "change_gap": _worst(prog["change"], refs["change"], moving),
    }
    if "route_gap" in refs:
        numbers["route_gap"] = refs["route_gap"]
    return numbers


def logit_gaps(arch: dict, params: dict, requests: list[dict], served: list[torch.Tensor],
               prec: ref.Precision, pick: ref.Precision | None = None) -> list[float]:
    """For every row of ``requests``: the reference's largest last-position logit
    less its logit of the served token. With ``pick`` the served tokens are not
    the program's but those that the reference in ``pick``'s precision puts
    first (the control)."""
    gaps = []
    for batch, tokens in zip(requests, served, strict=True):
        logits = ref.last_logits(arch, params, batch["tokens"], batch["positions"], prec)
        if pick is not None:
            tokens = ref.last_logits(arch, params, batch["tokens"], batch["positions"],
                                     pick).argmax(-1)
        chosen = logits.gather(1, tokens.to(logits.device).long()[:, None])[:, 0]
        gaps += (logits.max(-1).values - chosen).tolist()
    return gaps


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    if set(numbers) != set(limits):
        raise ValueError(f"numbers {sorted(numbers)} and limits {sorted(limits)} differ")
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in numbers}
    return all(numbers[n] <= limits[n] for n in numbers), checks
