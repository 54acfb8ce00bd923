"""The plain reference: the decoder, its loss and AdamW in plain PyTorch.

It imports nothing of the program. It computes what ``repro_torch`` computes
for the dense, MoE and VLM decoders (pre-norm RMSNorm scaled by 1 + gamma,
RoPE or Qwen2-VL's M-RoPE on rotated halves, causal GQA softmax attention,
SwiGLU or a top-k mixture of SwiGLU experts with a capacity, an untied head),
written out directly: attention materialises its scores, and each expert
gathers the tokens it keeps, where the program fills capacity buffers.

Routing is a discrete choice, as a served token is: where the reference's
top-k probabilities nearly tie, float32 rounding alone can make two sound
programs choose differently, and the steps after it then differ as much as a
lower precision makes them. So a training step can follow a given routing
(``Routing``): the reference takes the choices that the side it judges made,
and reads by how much each choice's probability lies below the reference's own
choice at that rank, as it reads a served token's logit below its best.

Every product of two tensors goes through ``Precision.mm``: float32 with TF32
off for the reference itself, and the lower precisions for the controls
(``Precision("tf32")`` rounds both operands to TF32, ``Precision("fp8")`` to
float8 e4m3 with a scale per tensor).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GROUP_TOKENS = 4096  # tokens a dispatch group holds at most: a row's tokens, in groups
ROUTER_EPS = 1e-9
NORM_EPS = 1e-6
FP8_MAX = 448.0  # the largest float8 e4m3 value


class Precision:
    """How the reference rounds the operands of every product."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def round(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.name == "tf32":  # 10 mantissa bits, to nearest, ties away from zero
            bits = x.contiguous().view(torch.int32)
            return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        if self.name == "fp8":
            scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
            return (x / scale).to(torch.float8_e4m3fn).float() * scale
        return x

    def mm(self, equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return torch.einsum(equation, a.float(), b.float())
        return _Rounded.apply(equation, a, b, self.round)


class _Rounded(torch.autograd.Function):
    """A product whose operands are rounded, in the backward pass too, as a
    lower-precision unit rounds them: "x,y->z" with every index of x in y or z,
    and of y in x or z."""

    @staticmethod
    def forward(ctx, equation, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.equation, ctx.rnd = equation, rnd
        return torch.einsum(equation, rnd(a), rnd(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, z = ctx.equation.split("->")
        x, y = ins.split(",")
        rnd = ctx.rnd
        grad_a = torch.einsum(f"{z},{y}->{x}", rnd(g), rnd(b))
        grad_b = torch.einsum(f"{x},{z}->{y}", rnd(a), rnd(g))
        return None, grad_a, grad_b, None


def no_tf32():
    """Float32 products stay float32 on the card (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, gamma):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + NORM_EPS) * (1.0 + gamma.float())


def rotate(x, angles):
    """x (B, S, H, D) rotated by angles (B, S, D/2): halves (x1, x2) of the head."""
    cos, sin = torch.cos(angles)[:, :, None], torch.sin(angles)[:, :, None]
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def angles_of(cfg: dict, positions, head_dim: int):
    """Rotation angles (B, S, D/2): RoPE of positions (B, S), or M-RoPE of
    positions (3, B, S), where frequency band j takes the position of the
    section (t, h or w) it falls in."""
    freqs = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, head_dim, 2, device=positions.device)
                                         .float() / head_dim))
    if cfg.get("mrope_sections"):
        band = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                       torch.tensor(cfg["mrope_sections"],
                                                    device=positions.device))
        pos = positions.float()[band].permute(1, 2, 0)  # (B, S, D/2)
        return pos * freqs
    return positions.float()[..., None] * freqs


def attention(cfg: dict, lp: dict, x, angles, prec: Precision):
    b, s, _ = x.shape
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = prec.mm("bsd,de->bse", x, lp["wq"]).reshape(b, s, h, hd)
    k = prec.mm("bsd,de->bse", x, lp["wk"]).reshape(b, s, kv, hd)
    v = prec.mm("bsd,de->bse", x, lp["wv"]).reshape(b, s, kv, hd)
    q, k = rotate(q, angles), rotate(k, angles)
    k = k.repeat_interleave(h // kv, dim=2)
    v = v.repeat_interleave(h // kv, dim=2)
    scores = prec.mm("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = prec.mm("bhqk,bkhd->bqhd", probs, v).reshape(b, s, h * hd)
    return prec.mm("bse,ed->bsd", o, lp["wo"])


def swiglu(x, w_gate, w_up, w_down, prec: Precision):
    g = prec.mm("td,df->tf", x, w_gate)
    u = prec.mm("td,df->tf", x, w_up)
    return prec.mm("tf,fd->td", F.silu(g) * u, w_down)


class Routing:
    """The routing of one pass. ``given``: for each MoE layer, the expert ids
    (G, T, k) chosen for its first G groups, which the pass takes in place of
    its own choices there; ``taken``: for each MoE layer, the choices the pass
    made (G, T, k); ``gap``: the widest by which a given choice's probability
    lies below that of the reference's own choice at the same rank."""

    def __init__(self, given: list | None = None):
        self.given, self.taken, self.gap = given, {}, 0.0


def route(cfg: dict, x, router, given=None):
    """The top-k routing of one group's tokens x (T, D): gates (T, k) renormalised
    over the k choices, experts (T, k) (the larger probability first; a tie goes
    to the lower index, or ``given``), whether each (token, choice) pair is kept
    (T, k), the group's load-balancing loss, and by how much the given choices'
    probabilities lie below the reference's own at their ranks (0 without)."""
    e, k = router.shape[1], cfg["top_k"]
    t = x.shape[0]
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    own = torch.sort(probs, dim=-1, descending=True, stable=True)
    experts, gap = own.indices[:, :k], 0.0
    if given is not None:
        experts = given.to(probs.device).long()
        gap = float((own.values[:, :k] - torch.gather(probs, 1, experts)).max().detach())
    gates = torch.gather(probs, 1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=ROUTER_EPS)
    cap = max(1, int(t * k * cfg["capacity_factor"] / e))
    # a pair's slot: the pairs of its expert before it, in token-major order
    flat = experts.reshape(-1)
    onehot = F.one_hot(flat, e)
    slot = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])[:, 0]
    keep = (slot < cap).reshape(t, k)
    density = F.one_hot(experts[:, 0], e).float().mean(0)
    aux = torch.sum(density * probs.mean(0)) * e
    return gates, experts, keep, aux, gap


def moe(cfg: dict, mp: dict, x, prec: Precision, routing: Routing | None = None,
        index: int = 0):
    """(y, aux) of the expert layer over x (B, S, D): each row cut into groups of
    at most GROUP_TOKENS tokens, routed and bounded by the capacity a group.
    ``routing``: the choices to take and to record, as MoE layer ``index``."""
    b, s, d = x.shape
    group = min(GROUP_TOKENS, s)
    if s % group:
        raise ValueError(f"the reference takes rows of whole groups, got {s} tokens")
    given = routing.given[index] if routing is not None and routing.given else None
    outs, auxes, taken = [], [], []
    for g, xg in enumerate(x.reshape(b * s // group, group, d)):
        gates, experts, keep, aux, gap = route(
            cfg, xg, mp["router"], given[g] if given is not None and g < len(given) else None)
        taken.append(experts.detach())
        if routing is not None:
            routing.gap = max(routing.gap, gap)
        auxes.append(aux)
        out = torch.zeros_like(xg)
        for e in range(mp["router"].shape[1]):
            tok, choice = torch.nonzero((experts == e) & keep, as_tuple=True)
            if tok.numel():
                ye = swiglu(xg[tok], mp["w_gate"][e], mp["w_up"][e], mp["w_down"][e], prec)
                out = out.index_add(0, tok, ye * gates[tok, choice][:, None])
        outs.append(out)
    if routing is not None:  # a layer run again for its backward pass chooses alike
        routing.taken[index] = torch.stack(taken)
    return torch.stack(outs).reshape(b, s, d), torch.stack(auxes).mean()


def layer(cfg: dict, lp: dict, h, angles, prec: Precision, routing: Routing | None = None,
          index: int = 0):
    h = h + attention(cfg, lp, rmsnorm(h, lp["attn_norm"]["scale"]), angles, prec)
    m = rmsnorm(h, lp["mlp_norm"]["scale"])
    if "moe" in lp:
        y, aux = moe(cfg, lp["moe"], m, prec, routing, index)
        return h + y, aux
    b, s, d = m.shape
    y = swiglu(m.reshape(b * s, d), lp["w_gate"], lp["w_up"], lp["w_down"], prec)
    return h + y.reshape(b, s, d), torch.zeros((), device=h.device)


def layer_weights(params: dict, i: int) -> dict:
    """Layer i's weights in float32 (the stacked leaves' i-th slices)."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return node[i].float()
    return pick(params["layers"])


def hidden(cfg: dict, params: dict, tokens, positions, prec: Precision, checkpoint=False,
           routing: Routing | None = None):
    """The final-norm hidden states (B, S, D) in float32 and the mean MoE loss
    over the layers. With ``checkpoint`` each layer keeps only its input for the
    backward pass and runs again there (to fit a training step in memory).
    ``routing``: the MoE layers' choices to take and to record."""
    h = params["embed"][tokens.long()].float()
    angles = angles_of(cfg, positions, cfg["head_dim"])
    aux = torch.zeros((), device=h.device)
    n = cfg["n_layers"]
    for i in range(n):
        run = lambda h_, i_=i: layer(cfg, layer_weights(params, i_), h_, angles, prec,  # noqa: E731
                                     routing, i_)
        if checkpoint and torch.is_grad_enabled():
            h, a = torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False)
        else:
            h, a = run(h)
        aux = aux + a
    return rmsnorm(h, params["final_norm"]["scale"]), aux / n


def last_logits(cfg: dict, params: dict, tokens, positions, prec: Precision):
    """The last position's logits (B, V) in float32, without autograd."""
    with torch.no_grad():
        h, _ = hidden(cfg, params, tokens, positions, prec)
        return prec.mm("bd,dv->bv", h[:, -1], params["unembed"])


def loss(cfg: dict, params: dict, batch: dict, prec: Precision, aux_weight: float,
         routing: Routing | None = None):
    """(cross-entropy + aux_weight · MoE loss, cross-entropy)."""
    h, aux = hidden(cfg, params, batch["tokens"], batch["positions"], prec, checkpoint=True,
                    routing=routing)
    logits = prec.mm("bsd,dv->bsv", h, params["unembed"])
    ce = torch.mean(torch.logsumexp(logits, -1)
                    - torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0])
    return ce + aux_weight * aux, ce


def learning_rate(ocfg: dict, step: int) -> float:
    """Linear warm-up, then a cosine to zero over ``total_steps``."""
    warm = min(step / max(1.0, ocfg["warmup_steps"]), 1.0)
    frac = min(max(step - ocfg["warmup_steps"], 0.0)
               / max(1.0, ocfg["total_steps"] - ocfg["warmup_steps"]), 1.0)
    return ocfg["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * frac))


def adamw(ocfg: dict, params: list, grads: list, m: list, v: list, step: int) -> list:
    """One AdamW step over flat lists, in place, after clipping the gradients'
    global norm; returns the gradients as the update took them (clipped, in
    place). A leaf at a time, so that a step needs two leaf-sized temporaries."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(ocfg["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
    lr = learning_rate(ocfg, step)
    b1, b2 = ocfg["b1"], ocfg["b2"]
    for p, g, mi, vi in zip(params, grads, m, v, strict=True):
        g.mul_(scale)
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        update = (mi / (1 - b1 ** step)).div_((vi / (1 - b2 ** step)).sqrt_().add_(ocfg["eps"]))
        p.sub_(update.add_(p, alpha=ocfg["weight_decay"]), alpha=lr)
    return grads
