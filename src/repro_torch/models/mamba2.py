"""Mamba-2 (SSD, state-space duality) language model: ``repro.models.mamba2`` in PyTorch.

Chunked SSD as in the JAX version: a within-chunk quadratic term plus an
inter-chunk linear state recurrence (a Python loop over the chunks where JAX
runs ``lax.scan``).  Decode keeps a constant-size recurrent state (B, H, P, N)
a layer.  The parameter layout is the JAX package's (per-layer weights
stacked on a leading axis under ``params["layers"]``), so
``repro_torch.testing.bridge`` moves weights one-to-one.  The family has no
attention, so ``forward`` accepts ``use_kernel`` and ignores it, as the JAX
``forward`` does through ``**_``.

The family runs sharded: given the rank's ``Comm`` as ``act_specs["mesh"]`` and
the ``Policy`` as ``act_specs["policy"]``, ``forward``, ``init_cache`` and
``decode_step`` run one rank's rows on its blocks of the parameters
(``parallel/tensor_parallel.py``), each layer's FSDP leaves (``w_in``'s rows,
``w_out``'s columns) all-gathered over ``data`` as it runs, the embedding and
unembedding gathered the same way (vocab-parallel where a ``tp=True`` policy
splits the vocab).  Under a ``tp=False`` policy (its ``default_policy``, and
``layout="fsdp"``) ``_mix`` runs on the whole weights and the decode state is
the rank's rows' whole state.  Under a ``tp=True`` one ``_mix`` runs on the
rank's P / n channels of every head (``_rank_weights``), and the decode state
is ``cache_specs``' block: the SSM state's P / n and the conv's channel block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.parallel import tensor_parallel as tp_lib


def dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.bfloat16):
    """Random weights on ``gen.device`` with the JAX version's layout and scales."""
    d = cfg.d_model
    di, h, p, n = dims(cfg)
    lshape = (cfg.n_layers,)
    conv_ch = di + 2 * n  # conv over x, B, C
    dev = gen.device
    layer = {
        "norm": L.stack_norm(cfg, cfg.n_layers, dev),
        # in_proj: d -> [z(di), x(di), B(n), C(n), dt(h)]
        "w_in": L.dense_init(gen, lshape + (d, 2 * di + 2 * n + h), dtype=dtype),
        "conv_w": (torch.randn(lshape + (cfg.conv_width, conv_ch), generator=gen, device=dev)
                   * 0.1).to(dtype),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev)
                           ).expand(lshape + (h,)).clone(),
        "D": torch.ones(lshape + (h,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lshape + (h,), dtype=torch.float32, device=dev),
        "w_out": L.dense_init(gen, lshape + (di, d), dtype=dtype),
    }
    return {
        "embed": L.embed_init(gen, (cfg.vocab, d), dtype=dtype),
        "layers": layer,
        "final_norm": L.norm_params(d, cfg.norm_type, device=dev),
        "unembed": L.dense_init(gen, (d, cfg.vocab), dtype=dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Segment sums: out[..., i, j] = sum_{k=j+1..i} x[..., k] (0 on the diagonal);
    -inf above the diagonal.  Each is summed on its own, a cumulative sum of x
    masked to k > j, where the JAX version subtracts two cumulative sums of the
    whole chunk: the decays dt·A add up to thousands over a chunk, and their
    difference keeps float32's absolute error at that scale, which the SSD's
    exponentials then amplify."""
    t = x.shape[-1]
    low = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device), diagonal=-1)
    out = torch.cumsum(x[..., None].expand(*x.shape, t).masked_fill(~low, 0), dim=-2)
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return out.masked_fill(~keep, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD scan. x:(b,s,h,p), dt:(b,s,h) (post-softplus), A:(h,) (negative),
    B,C:(b,s,n).  Returns (y (b,s,h,p) in x's dtype, final_state (b,h,p,n) fp32).

    Computed in float32 (float64 for float64 x).  The JAX version's four-operand einsum
    ``bcln,bcsn,bchls,bcshp->bclhp`` runs as C·Bᵀ, times the decay matrix,
    times x·dt, so no (b, c, h, l, s, p) intermediate is formed.  The decays
    within a chunk are sums of their own terms (``_segsum``), not differences
    of cumulative sums as in JAX: the same function, at float32's relative
    error rather than at its error on the chunk's whole decay (mamba2-130m at 4
    layers, 1 x 512 tokens, on the CPU: the fp32 gradient 9.1e-3 from fp64
    (relative L2) with the differences, 3.7e-5 without).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk
    xr = L.wide(x.reshape(b, nc, chunk, h, p))
    dtr = dt.reshape(b, nc, chunk, h).to(xr.dtype)
    Br = B.reshape(b, nc, chunk, n).to(xr.dtype)
    Cr = C.reshape(b, nc, chunk, n).to(xr.dtype)

    dA = dtr * A.to(xr.dtype)  # (b,nc,q,h)  negative
    dA_cs = torch.cumsum(dA, dim=2)  # (b,nc,q,h)

    # 1) intra-chunk (quadratic) term
    Lmat = torch.exp(_segsum(dA.movedim(-1, -2)))  # (b,nc,h,q,q)
    xdt = xr * dtr[..., None]
    scores = torch.einsum("bcln,bcsn->bcls", Cr, Br)  # (b,nc,q,q)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores[:, :, None] * Lmat, xdt)

    # 2) chunk states; the decay from each position to the chunk's end,
    # exp(sum_{k>l} dA_k), summed from the end (as _segsum, not a difference)
    rev = torch.cumsum(dA.flip(2), dim=2).flip(2)  # sum_{k>=l} dA_k
    decay_states = torch.exp(F.pad(rev[:, :, 1:], (0, 0, 0, 1)))  # (b,nc,q,h)
    states = torch.einsum("bclhp,bcln->bchpn", (decay_states * dtr)[..., None] * xr, Br)

    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (b,nc,h)
    prev = (torch.zeros((b, h, p, n), dtype=xr.dtype, device=x.device)
            if init_state is None else init_state.to(xr.dtype))
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)  # (b,nc,h,p,n)

    # 4) off-chunk contribution
    state_decay = torch.exp(dA_cs)  # (b,nc,q,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cr, prev_states) * state_decay[..., None]

    y = (y_diag + y_off).reshape(b, sp, h, p)
    if pad:
        y = y[:, :s]
    return y.to(x.dtype), prev


def _rank_weights(cfg: ArchConfig, tp, lp):
    """The rank's share of a layer's weights (FSDP undone) under a ``tp=True``
    view, and the indices of its channels among d_inner: P / n of every head's
    (head h, its channels h·P + index·P / n + j).  ``w_in`` and ``w_out`` are read
    whole (``TensorParallel.read``) and the rank takes ``w_in``'s columns of its z
    channels, of its block of the conv channels (``conv_w``'s block; all of them
    where ``conv_w`` is whole over ``model``) and every head's dt, and
    ``w_out``'s rows of its channels.  ``conv_w`` where whole, ``A_log``, ``D`` and
    ``dt_bias`` enter through ``pvary``: the rank reads them for its channels
    only, so their gradients sum over ``model``."""
    di, h, p, n = dims(cfg)
    plan = tp.plan.stack("layers")
    pl = p // tp.n
    dev = lp["w_in"].device
    ch = (torch.arange(h, device=dev)[:, None] * p + tp.index * pl
          + torch.arange(pl, device=dev)).reshape(-1)
    c = lp["conv_w"].shape[-1]
    lo = di + (tp.index * c if plan["conv_w"].split[1] else 0)
    cols = torch.cat([ch, torch.arange(lo, lo + c, device=dev),
                      torch.arange(2 * di + 2 * n, 2 * di + 2 * n + h, device=dev)])
    return {
        "norm": lp["norm"],
        "w_in": tp.read(lp["w_in"], plan["w_in"])[:, cols],
        "conv_w": lp["conv_w"] if plan["conv_w"].split[1] else tp.pvary(lp["conv_w"]),
        **{k: tp.pvary(lp[k]) for k in ("A_log", "D", "dt_bias")},
        "w_out": tp.read(lp["w_out"], plan["w_out"])[ch],
    }, ch


def _mix(cfg: ArchConfig, lp, x, conv_state=None, ssm_state=None, single_step=False,
         tp=None):
    """One mamba2 mixing layer. Returns (y, new_conv_state, new_ssm_state).

    With ``tp`` (a view that splits over ``model``) ``x`` is replicated over
    ``model`` and the layer runs on the rank's channels (``_rank_weights``): the
    conv on its block of the conv channels, all-gathered over ``model`` after the
    silu, the scan on its x channels with the whole B and C, the states the
    rank's, the output its rows' part summed over ``model``."""
    b, s, d = x.shape
    di, h, p, n = dims(cfg)
    ch = None
    if tp is not None:  # x is replicated over model; the rank's columns give a part of d(x)
        lp, ch = _rank_weights(cfg, tp, lp)
        x = tp.pvary(x)
    proj = x @ lp["w_in"]
    c = lp["conv_w"].shape[-1]
    z, conv_in, dt = torch.split(proj, [proj.shape[-1] - c - h, c, h], dim=-1)
    conv_out, new_conv = L.causal_conv1d(conv_in, lp["conv_w"], conv_state)
    conv_out = F.silu(conv_out)
    if tp is not None and c < di + 2 * n:  # the rank's block -> every conv channel
        conv_out = tp.all_columns(conv_out)
    xc, Bc, Cc = torch.split(conv_out, [di, n, n], dim=-1)
    if ch is not None:
        xc = xc[..., ch]
    dt = F.softplus(dt.float() + lp["dt_bias"])
    A = -torch.exp(lp["A_log"])
    xh = xc.reshape(b, s, h, -1)
    if single_step:
        # recurrent step: state' = exp(dt*A) state + dt * B ⊗ x, in float32
        dA = torch.exp(dt[:, 0] * A)  # (b,h)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], Bc[:, 0].float(), xh[:, 0].float())
        new_state = ssm_state * dA[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cc[:, 0].float(), new_state)[:, None]
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk, ssm_state)
    y = y + lp["D"][None, None, :, None] * xh[:, :s]  # float32, as JAX promotes
    y = y.reshape(b, s, -1).to(x.dtype)
    y = y * F.silu(z)
    out = y @ lp["w_out"]
    return (out if tp is None else tp.sum(out)), new_conv, new_state


def _layer(cfg: ArchConfig, lp, h, aux, positions=None, enc=None, use_kernel=False, tp=None):
    """One residual layer of ``layer_sequence``: (h, aux) -> (h + mix(norm(h)), aux);
    with ``tp`` ``lp`` holds the rank's blocks, all-gathered over ``data`` here,
    and the mix runs on the rank's channels under a ``tp=True`` view."""
    if tp is not None:
        lp = tp.layer(lp)
    a = L.apply_norm(h, lp["norm"], cfg.norm_type)
    y, _, _ = _mix(cfg, lp, a, tp=None if tp is None else tp.model_view)
    return h + y, aux


def layer_sequence(cfg: ArchConfig) -> list:
    """(stack, index, layer) of every layer in forward order (``transformer.
    layer_sequence``'s signature): the ``layers`` stack's."""
    return [("layers", i, _layer) for i in range(cfg.n_layers)]


def forward(cfg: ArchConfig, params, tokens: torch.Tensor, remat: bool = True, act_specs=None,
            return_hidden: bool = False, **_):
    """Full forward pass -> (logits, 0.0), tokens (B, S) integer.

    With ``remat`` and autograd on, each layer runs under
    ``torch.utils.checkpoint`` (the JAX version's ``jax.checkpoint``).  Other
    keywords (``use_kernel``, ``positions``) are accepted and ignored.  With
    ``return_hidden`` the final-norm hidden states come back in place of the
    logits.  With a sharded ``act_specs`` (the module docstring) ``params`` are
    the rank's blocks and ``tokens`` its rows; the logits come back for the last
    position only, (B, 1, V)."""
    tp = tp_lib.context(cfg, act_specs)
    if tp is not None:
        tp.check(params)
    x = params["embed"][tokens.long()] if tp is None else tp.embed(params, tokens)
    x = L.run_sequence(cfg, layer_sequence(cfg), params, x, remat, tp=tp)
    return L.head(cfg, params, x, tp, return_hidden)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
               act_specs=None):
    """Constant-size state: conv tail + SSM state per layer (``max_len`` is not
    needed).  With a sharded ``act_specs`` the rank's rows' state: whole under a
    ``tp=False`` policy, under a ``tp=True`` one ``cache_specs``' block (P / n of
    every head's SSM state, the conv's channel block where ``model`` divides the
    conv channels)."""
    tp = tp_lib.context(cfg, act_specs)
    split = None if tp is None else tp.model_view
    di, h, p, n = dims(cfg)
    conv_ch = di + 2 * n
    if split is not None:
        p //= split.n
        if conv_ch % split.n == 0:
            conv_ch //= split.n
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, h, p, n), dtype=torch.float32, device=device),
        "len": 0,
    }


def decode_step(cfg: ArchConfig, params, cache, tokens, positions=None, act_specs=None):
    """One-token decode: tokens (B, 1) -> (logits (B,1,V), cache).

    As ``transformer.decode_step``, the new states are written into the
    cache passed in, which is the one returned, and ``cache["len"]`` is a
    Python int.  With a sharded ``act_specs`` ``params`` are the rank's blocks,
    ``tokens`` its rows and ``cache`` its ``init_cache``; the logits are the whole
    vocab's on every rank along ``model``.
    """
    tp = tp_lib.context(cfg, act_specs)
    split = None if tp is None else tp.model_view
    if tp is not None:
        tp.check(params)
    x = params["embed"][tokens.long()] if tp is None else tp.embed(params, tokens)
    for i, lp in enumerate(L.unstack(params["layers"], cfg.n_layers)):
        if tp is not None:
            lp = tp.layer(lp)
        a = L.apply_norm(x, lp["norm"], cfg.norm_type)
        y, new_conv, new_ssm = _mix(cfg, lp, a, cache["conv"][i], cache["ssm"][i],
                                    single_step=True, tp=split)
        cache["conv"][i].copy_(new_conv)
        cache["ssm"][i].copy_(new_ssm)
        x = x + y
    x = L.apply_norm(x, params["final_norm"], cfg.norm_type)
    logits = x @ L.unembed(params) if tp is None else tp.logits(params, x, mask=False)
    cache["len"] += 1
    return logits, cache
