"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``).

GShard-style top-k routing with a capacity bound, in three strategies, as in
the JAX package:

* ``moe_apply`` (default): *scatter/gather dispatch*.  Tokens are grouped in
  fixed-size sequence chunks; each group scatters its routed tokens into an
  ``(E, C, D)`` capacity buffer, runs the expert GEMMs batched over E, and
  gathers back.  The JAX version maps one group at a time with ``vmap``;
  here every group of the call goes through one batched dispatch, so a
  decode step at batch B is one dispatch a layer.
* ``moe_apply_gshard``: the same routing through one-hot dispatch and
  combine tensors contracted with einsums.
* ``moe_apply_tp``: ``moe_apply`` on one rank of tensor parallelism over
  ``model`` with the experts split on d_ff (``parallel/tensor_parallel.py``),
  the "operator parallelism" of the JAX docstring.
* ``moe_apply_gshard_tp``: ``moe_apply_gshard`` on one rank whose view splits
  the experts over ``model`` (``moe_mode`` "ep" or "gshard" under a
  ``tp=True`` policy): the rank's E / n experts, one sum over ``model``.
* ``moe_apply_ep``: *expert parallelism* over a ``core.comm`` mesh.  Each
  rank holds ``E / n`` experts; the token slabs move with
  ``Comm.all_to_all``, the MoE all-to-all traffic the paper analyses for
  GPT-3-MoE (§V-B5).  Its tokens are one dispatch group; with ``group``,
  together with other ranks' (the sharded layout: the whole batch, as JAX's
  shard_map body routes it), each rank keeping its own.

The router runs in float32 whatever the activations' type.  Positions in the
capacity buffer come from a cumulative count in token-major order over the
(token, choice) pairs; pairs past the capacity are clamped to its last slot
and zeroed.  Top-k ties go to the lower expert index, as ``lax.top_k`` does
(``torch.topk`` orders ties otherwise, so the choice is a stable sort).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import trace

GROUP_TOKENS = 4096  # tokens per dispatch group (bounds the capacity buffer)


def capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    return max(1, int(group * top_k * factor / n_experts))


def _top_k(probs, top_k: int):
    """The k experts of largest probability, largest first: (..., T, k) int64."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :top_k]


def _gates_and_aux(probs, experts, n_experts: int):
    """The gates of the chosen ``experts`` (their probabilities, renormalised over
    the k choices) and the load-balancing loss (Switch/GShard): the density of
    each token's first choice times the mean router probability, summed over
    experts, times E, over the T tokens of each leading index."""
    gates = torch.gather(probs, -1, experts)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(experts[..., 0], n_experts).float().mean(-2)
    aux = torch.sum(density * probs.mean(-2), dim=-1) * n_experts
    return gates, aux


def _probs(x, w_router):
    """The router's probabilities (..., T, E) in float32 of x (..., T, D)."""
    return torch.softmax(torch.einsum("...td,de->...te", x.float(), w_router.float()), dim=-1)


def _route(x, w_router, top_k):
    """x: (..., T, D) -> gates (..., T, k) f32, experts (..., T, k) int64, aux (...)."""
    probs = _probs(x, w_router)
    experts = _top_k(probs, top_k)
    gates, aux = _gates_and_aux(probs, experts, w_router.shape[1])
    return gates, experts, aux


def _slots(experts, n_experts: int, cap: int, prefix=None, rows: int | None = None):
    """The capacity slot of every (token, choice) pair, token-major.

    experts: (G, T, k) -> flat_e (G, T·k), the clamped position pos_c (G, T·k)
    in that expert's buffer, and keep (G, T·k) bool: the pair fits.  With
    ``prefix`` (E,), the pairs of each expert that come before these in a
    dispatch group spread over ranks (``_group_slots``): a pair's slot is its
    position here plus its expert's prefix, and it fits below ``cap``; its
    buffer row is its position here, in a buffer of ``rows`` rows (the kept
    pairs of an expert are the first ones here).
    """
    flat_e = experts.reshape(experts.shape[0], -1)
    # the one-hot as (G, E, T·k), so that the count runs along the last axis:
    # along the middle axis of a (G, T·k, E) one-hot it took 3.5 ms a layer on
    # an H100 at a prefill of 4 × 2048 tokens, 30 times as long
    experts_ids = torch.arange(n_experts, device=flat_e.device)
    onehot = (flat_e[:, None, :] == experts_ids[None, :, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot  # position within the expert
    pos_of = torch.gather(pos, 1, flat_e[:, None, :])[:, 0].long()
    slot = pos_of if prefix is None else pos_of + prefix[flat_e]
    return flat_e, torch.clamp(pos_of, max=(rows or cap) - 1), slot < cap


def _group_slots(gather, index: int, probs, experts, n_experts: int, capacity_factor: float):
    """What a rank needs to dispatch its tokens (``probs`` (1, t, E), ``experts``
    (1, t, k)) as a part of one group with the other ranks' (``moe_apply_ep``'s
    ``group``): the group's capacity, the rank's buffer rows, each expert's
    pairs on the ranks before it (E,) and the group's aux loss.

    One vector a rank, its pairs and first choices by expert and its router
    probabilities summed over its tokens, is gathered (``gather``: its
    transpose sums the gradients of the ranks' copies).  The counts are
    integers, exact in float32; the aux takes the density and the mean
    probability of all the group's tokens, as ``_route`` of their one group.
    A rank's pairs of one expert number at most its t tokens, and the kept
    ones at most the capacity: its buffers take min(t, cap) rows."""
    e, (_, t, k) = n_experts, experts.shape
    ids = torch.arange(e, device=experts.device)
    pairs = (experts.reshape(-1, 1) == ids).sum(0)
    first = (experts[0, :, 0, None] == ids).sum(0)
    every = gather(torch.cat([pairs.float(), first.float(), probs[0].sum(0)]))  # (n, 3E)
    tokens = t * every.shape[0]
    cap = capacity(tokens, k, e, capacity_factor)
    counts = every[:, :2 * e].detach().round().long()
    prefix = counts[:index, :e].sum(0)
    density = counts[:, e:].sum(0).float() / tokens
    aux = torch.sum(density * every[:, 2 * e:].sum(0) / tokens) * e
    return cap, min(t, cap), prefix, aux


def _scatter(xg, flat_e, pos_c, keep, n_experts: int, cap: int, top_k: int):
    """xg (G, T, D) -> the capacity buffers (G, E, C, D): each kept pair's token
    added at its slot (an accumulating ``index_put``, as ``.at[].add``)."""
    g, _, d = xg.shape
    xrep = torch.repeat_interleave(xg, top_k, dim=1)  # (G, T·k, D), as jnp.repeat
    gi = torch.arange(g, device=xg.device)[:, None].expand_as(flat_e)
    buf = xg.new_zeros((g, n_experts, cap, d))
    return buf.index_put((gi, flat_e, pos_c), xrep * keep.to(xg.dtype)[..., None],
                         accumulate=True)


def _gather(out, flat_e, pos_c, keep, gates, top_k: int):
    """out (G, E, C, D) -> (G, T, D): each pair's expert output, weighted by its
    gate (zero where dropped), summed over the k choices."""
    g, _, _, d = out.shape
    gi = torch.arange(g, device=out.device)[:, None].expand_as(flat_e)
    y_choice = out[gi, flat_e, pos_c]  # (G, T·k, D)
    w = keep.to(out.dtype) * gates.reshape(g, -1).to(out.dtype)
    y_choice = y_choice * w[..., None]
    return y_choice.reshape(g, -1, top_k, d).sum(dim=2)


class _SiluMul(torch.autograd.Function):
    """silu(g) · u, keeping g and u for the backward, which recomputes silu(g)
    there: of the experts' four (..., C, F) intermediates (g, u, silu(g), the
    product) two stay alive in training.  The gradients are autograd's own
    (``aten.silu_backward`` and the product's), bit for bit."""

    @staticmethod
    def forward(ctx, g, u):
        ctx.save_for_backward(g, u)
        return F.silu(g) * u

    @staticmethod
    def backward(ctx, grad):
        g, u = ctx.saved_tensors
        return torch.ops.aten.silu_backward(grad * u, g), grad * F.silu(g)


def _experts_ffn(buf, w_gate, w_up, w_down):
    """SwiGLU of every expert on its buffer, batched over experts: buf (..., E, C, D)."""
    with trace.span("moe.experts") as sp:
        buf = sp.inputs(buf)
        h = _SiluMul.apply(torch.einsum("...ecd,edf->...ecf", buf, w_gate),
                           torch.einsum("...ecd,edf->...ecf", buf, w_up))
        return sp.outputs(torch.einsum("...ecf,efd->...ecd", h, w_down))


def _group_dispatch(xg, gates, experts, w_gate, w_up, w_down, cap):
    """Every group at once: xg (G, T, D); experts (G, T, k); returns (G, T, D)."""
    e, k = w_gate.shape[0], experts.shape[-1]
    flat_e, pos_c, keep = _slots(experts, e, cap)
    if trace.on():  # the pairs routed, those that fit, and the buffers' rows
        trace.count("moe.pairs", keep.numel())
        trace.count("moe.kept", keep.sum())
        trace.count("moe.slots", keep.shape[0] * e * cap)
    buf = _scatter(xg, flat_e, pos_c, keep, e, cap, k)
    out = _experts_ffn(buf, w_gate, w_up, w_down)
    return _gather(out, flat_e, pos_c, keep, gates, k)


def _groups(x):
    """x (B, S, D) -> (groups (B·n, G, D), n, G, pad): S padded to n groups of G."""
    b, s, d = x.shape
    group = min(GROUP_TOKENS, s)
    n_groups = (s + group - 1) // group
    pad = n_groups * group - s
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    return xp.reshape(b * n_groups, group, d), n_groups, group, pad


def moe_apply(x, params, top_k: int, capacity_factor: float = 1.25):
    """x: (B, S, D) -> ((B, S, D), aux). params: router (D, E), w_gate/up
    (E, D, F), w_down (E, F, D)."""
    with trace.span("moe") as sp:
        x = sp.inputs(x)
        b, s, d = x.shape
        xg, n_groups, group, pad = _groups(x)
        e = params["router"].shape[1]
        cap = capacity(group, top_k, e, capacity_factor)
        gates, experts, aux = _route(xg, params["router"], top_k)
        y = _group_dispatch(xg, gates, experts, params["w_gate"], params["w_up"],
                            params["w_down"], cap)
        y = y.reshape(b, n_groups * group, d)
        if pad:
            y = y[:, :s]
        return sp.outputs(y, torch.mean(aux))


def moe_apply_tp(tp, x, params, top_k: int, capacity_factor: float = 1.25):
    """``moe_apply`` on one rank of tensor parallelism over ``model``: x (B, S, D)
    replicated over ``model``; params the router (D, E) and the rank's F columns
    of every expert, w_gate/w_up (E, D, F/n), w_down (E, F/n, D) (FSDP undone);
    ``tp`` the rank's ``tensor_parallel.TensorParallel``.

    1. The rank routes and dispatches its tokens (``_route``, ``_slots``,
       ``_scatter``): the same bits on every rank along ``model``, whose x
       comes out of the previous row sum bit-equal.
    2. It runs every expert on its F columns (``_experts_ffn``): a part of
       each expert's output.
    3. It combines its parts (``_gather``, linear in them): a part of y.
    4. The parts are summed over ``model`` (``tp.sum``, the row sum).

    The sum carries (B, S, D), top_k x capacity_factor times fewer bytes than
    the (E, C, D) buffer that GSPMD psums after the row-parallel ``w_down``.
    The buffer and the gates enter the rank's own products through
    ``tp.pvary``, whose transpose psums their gradients over ``model``, so the
    router's and x's gradients are whole on every rank.  The aux loss is the
    mean over the rank's groups, the same on every rank along ``model``."""
    b, s, d = x.shape
    xg, n_groups, group, pad = _groups(x)
    e = params["router"].shape[1]
    cap = capacity(group, top_k, e, capacity_factor)
    gates, experts, aux = _route(xg, params["router"], top_k)
    flat_e, pos_c, keep = _slots(experts, e, cap)
    buf = _scatter(xg, flat_e, pos_c, keep, e, cap, top_k)
    out = _experts_ffn(tp.pvary(buf), params["w_gate"], params["w_up"], params["w_down"])
    y = _gather(out, flat_e, pos_c, keep, tp.pvary(gates), top_k).reshape(b, n_groups * group, d)
    if pad:
        y = y[:, :s]
    return tp.sum(y), torch.mean(aux)


def _one_hots(flat_e, pos_c, keep, gates, cap: int, dt, n: int, lo=None):
    """The dispatch and combine tensors (G, T·k, n, C) of the n experts (``gates``
    (G, T, k)): each kept pair's one-hot at its expert and slot, the combine's
    weighted by its gate.  With ``lo``, of experts [lo, lo + n) out of more:
    the other experts' pairs drop out."""
    local = flat_e
    if lo is not None:
        local = flat_e - lo
        keep = keep & (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
    disp = (F.one_hot(local, n).to(dt)[..., None]
            * F.one_hot(pos_c, cap).to(dt)[..., None, :]
            * keep.to(dt)[..., None, None])  # (G, T·k, n, C)
    return disp, disp * gates.reshape(gates.shape[0], -1)[..., None, None].to(dt)


def moe_apply_gshard(x, params, top_k: int, capacity_factor: float, expert_spec=None):
    """GShard-style einsum dispatch: one-hot (G, T·k, E, C) dispatch and combine
    tensors in place of the scatter and gather.

    ``expert_spec`` is the JAX version's layout constraint on the (G, E, C, D)
    buffers (``activation_specs``' ``"experts"``): accepted, and it changes no
    number.
    """
    b, s, d = x.shape
    xg, n_groups, group, pad = _groups(x)
    e = params["router"].shape[1]
    cap = capacity(group, top_k, e, capacity_factor)
    gates, experts, aux = _route(xg, params["router"], top_k)
    flat_e, pos_c, keep = _slots(experts, e, cap)
    disp, comb = _one_hots(flat_e, pos_c, keep, gates, cap, xg.dtype, e)
    xrep = torch.repeat_interleave(xg, top_k, dim=1)  # (G, T·k, D)
    buf = torch.einsum("gtec,gtd->gecd", disp, xrep)
    out = _experts_ffn(buf, params["w_gate"], params["w_up"], params["w_down"])
    y = torch.einsum("gtec,gecd->gtd", comb, out)
    return _gshard_regroup(y, b, n_groups, group, top_k, d, pad, s), torch.mean(aux)


def moe_apply_gshard_tp(tp, x, params, top_k: int, capacity_factor: float = 1.25):
    """``moe_apply_gshard`` on one rank of a view whose experts are split over
    ``model``: x (B, S, D) replicated over ``model``; params the router (D, E)
    and the rank's E / n whole experts, w_gate/w_up (E/n, D, F), w_down (E/n, F,
    D) (FSDP undone), the rank holding experts [i·E/n, (i+1)·E/n) at
    ``tp.index`` i.

    1. The rank routes every token (``_route``, ``_slots``): the same bits on
       every rank along ``model``.
    2. It builds the dispatch and combine tensors of its experts only, (G, T·k,
       E/n, C), its buffers (G, E/n, C, D), and runs its experts on them.
    3. It combines their outputs (linear in them): its experts' part of y,
       regrouped to (B, S, D).
    4. The parts are summed over ``model`` once (``tp.sum``, the row sum): the
       "(T, D) combine psum" of the JAX docstring; no buffer crosses ranks.

    x and the gates enter the rank's own products through ``tp.pvary``, whose
    transpose psums their gradients over ``model``, so the router's and x's
    gradients are whole on every rank, and each expert's is its owner's.  The
    aux loss is the mean over the rank's groups, the same on every rank along
    ``model``.  In groups of one token (decode) this is ``moe_apply``'s
    function, as ``moe_apply_gshard``'s is."""
    b, s, d = x.shape
    xg, n_groups, group, pad = _groups(x)
    e, el = params["router"].shape[1], params["w_gate"].shape[0]
    cap = capacity(group, top_k, e, capacity_factor)
    gates, experts, aux = _route(xg, params["router"], top_k)
    flat_e, pos_c, keep = _slots(experts, e, cap)
    disp, comb = _one_hots(flat_e, pos_c, keep, tp.pvary(gates), cap, xg.dtype, el,
                           tp.index * el)
    xrep = torch.repeat_interleave(tp.pvary(xg), top_k, dim=1)  # (G, T·k, D)
    buf = torch.einsum("gtec,gtd->gecd", disp, xrep)  # (G, E/n, C, D)
    out = _experts_ffn(buf, params["w_gate"], params["w_up"], params["w_down"])
    y = torch.einsum("gtec,gecd->gtd", comb, out)
    return tp.sum(_gshard_regroup(y, b, n_groups, group, top_k, d, pad, s)), torch.mean(aux)


def _gshard_regroup(y, b, n_groups, group, top_k, d, pad, s):
    # y: (G, T·k, D) contributions per (token, choice); fold the k copies.
    y = y.reshape(b * n_groups, group, top_k, d).sum(dim=2)
    y = y.reshape(b, n_groups * group, d)
    if pad:
        y = y[:, :s]
    return y


def moe_apply_ep(comm, x, params, top_k: int, capacity_factor: float, axis: str = "model",
                 exchange=None, vary=None, group=None):
    """Expert-parallel MoE on one rank of a mesh (the body of JAX's shard_map).

    ``params`` holds the full router (D, E) and this rank's ``E / n`` experts
    (w_gate/w_up (E/n, D, F), w_down (E/n, F, D)), rank i holding experts
    [i·E/n, (i+1)·E/n) along ``axis``; ``x`` (B, S, D) is this rank's tokens,
    all in one group.  The local tokens are dispatched into per-expert
    capacity slabs, exchanged with ``Comm.all_to_all`` so that each rank
    receives the slabs of its own experts from every peer, computed, and
    exchanged back.  The exchange has a backward (the same exchange), so
    gradients flow to the local experts from every rank's tokens.

    ``exchange`` replaces the all-to-all over ``axis`` (a sharded view's, which
    keeps it out of autograd on the cut route), and ``vary`` is applied to the
    tokens the slabs take and to the gates the combine takes (a view's
    ``pvary`` where the tokens are the same on every rank along ``axis``).

    ``group`` makes this rank's tokens a part of one dispatch group with other
    ranks', as JAX's body routes the whole batch where its data axes are
    automatic: ``(gather, index)``, ``gather(v)`` stacking a vector of every
    rank of the group in the order of their rows, (n, len(v)), and ``index``
    this rank's place there.  The capacity is the group's, a pair's slot
    counts the pairs of its expert on the ranks before it, and the aux loss
    is the group's (``_group_slots``); the rank keeps its own tokens, in slabs
    of min(its tokens, the capacity) rows.
    """
    b, s, d = x.shape
    n_dev = comm.axis_size(axis)
    e_local = params["w_gate"].shape[0]
    e = e_local * n_dev
    t = b * s
    exchange = exchange or (lambda slabs: comm.all_to_all(slabs, axis))
    vary = vary or (lambda v: v)
    xt = x.reshape(1, t, d)
    probs = _probs(xt, params["router"])
    experts = _top_k(probs, top_k)
    gates, aux = _gates_and_aux(probs, experts, e)
    if group is None:
        cap = rows = capacity(t, top_k, e, capacity_factor)
        flat_e, pos_c, keep = _slots(experts, e, cap)
        aux = aux[0]
    else:
        cap, rows, prefix, aux = _group_slots(*group, probs, experts, e, capacity_factor)
        flat_e, pos_c, keep = _slots(experts, e, cap, prefix, rows)
    slabs = _scatter(vary(xt), flat_e, pos_c, keep, e, rows, top_k)[0]  # (E, rows, D)
    # exchange: (E, rows, D) -> (n_dev, e_local, rows, D) -> all-to-all over dim 0
    recv = exchange(slabs.reshape(n_dev, e_local, rows, d))
    # recv: (n_dev, e_local, rows, D): token slabs from every peer for MY experts
    out = _experts_ffn(recv, params["w_gate"], params["w_up"], params["w_down"])
    back = exchange(out).reshape(1, e, rows, d)
    y = _gather(back, flat_e, pos_c, keep, vary(gates), top_k)
    return y.reshape(b, s, d), aux
