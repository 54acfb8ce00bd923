"""Pipeline parallelism (GPipe) over ``Comm.ppermute`` (counterpart of ``repro.parallel.pipeline``).

The paper models the pipeline dimension as rings with nearest-neighbour
volume ``V_P`` a hop (§II-B, §V-B1-b).  Here the P dimension is a mesh axis:
each rank of ``Mesh.run`` holds one stage's parameters, and microbatches flow
from stage to stage by ``Comm.ppermute``.

``pipeline_forward`` runs M microbatches through P stages in M + P - 1 ticks,
JAX's schedule exactly: stage 0 injects microbatch ``min(t, M - 1)``, every
stage runs ``stage_fn`` on every tick (the bubble ticks too, on whatever it
holds), the last stage writes output ``t - (P - 1)`` once ``t >= P - 1``, and
the handoff is a ppermute over ``[(i, i + 1)]``, so stage 0 receives zeros.
Selections are ``torch.where`` on tensors, as JAX's ``jnp.where``, so that
every rank builds the same autograd graph: the backward's ppermutes (the
reversed pairs) then run on every rank in the same order.
``make_pipelined_loss`` masks the loss to the last stage and ``psum``s it;
``loss.backward()`` on every rank gives each its stage's gradient, equal to
JAX's ``jax.grad`` of the ``shard_map``'d loss (not P times it: see
``Comm.psum``).  That route needs an autograd engine thread a rank: the CPU,
or one process a rank.

``make_pipelined_value_and_grad`` is the route for rank threads that share
one GPU, whose backwards would queue on the device's one autograd thread and
deadlock at the first collective.  It keeps every collective out of the
autograd graph: it runs the forward ticks without autograd, keeping each
tick's stage input; then the ticks in reverse, each one receiving the
gradient of its handoff by a plain ppermute over the reversed pairs, adding
the last stage's output gradient, and running the backward of the stage on
its saved input (a graph local to the rank) into the stage's parameters,
whose gradients add up in place, and its input.  These are the steps of JAX's
transposed loop, so
the gradients are the same numbers as the other route's, and the backward
moves the forward's bytes again.
"""

from __future__ import annotations

import torch

from repro_torch import tree as tree_lib


def _schedule(comm, axis: str, m: int):
    """(P, this rank's stage index, the forward pairs, the tick count)."""
    p = comm.axis_size(axis)
    return p, comm.axis_index(axis), [(i, i + 1) for i in range(p - 1)], m + p - 1


def pipeline_forward(comm, stage_fn, stage_params, x_micro: torch.Tensor, axis: str):
    """Run on one rank of ``Mesh.run`` (JAX: inside ``shard_map`` over ``axis``).

    stage_fn(params, x) -> y            one stage's computation
    stage_params                        this rank's stage parameters
    x_micro: (M, mb, ...)               microbatches (the same on every stage;
                                        only stage 0 reads them)
    Returns (M, mb, ...) outputs, valid on the LAST stage (zeros elsewhere).
    """
    m = x_micro.shape[0]
    p, idx, fwd, ticks = _schedule(comm, axis, m)
    dev = x_micro.device
    first = torch.tensor(idx == 0, device=dev)
    state = torch.zeros_like(x_micro[0])
    outputs = list(torch.zeros_like(x_micro).unbind(0))
    for t in range(ticks):
        x_in = torch.where(first, x_micro[min(t, m - 1)], state)
        y = stage_fn(stage_params, x_in)
        oi = min(max(t - (p - 1), 0), m - 1)
        write = torch.tensor(idx == p - 1 and t >= p - 1, device=dev)
        outputs[oi] = torch.where(write, y, outputs[oi])
        state = comm.ppermute(y, axis, fwd)
    return torch.stack(outputs)


def make_pipelined_loss(stage_fn, final_fn, axis: str):
    """Loss over pipelined stages; ``final_fn(outputs, labels)`` maps the last
    stage's outputs to the loss.

    Returns f(comm, stage_params, x_micro, labels_micro) -> the loss, the same
    on every rank of ``axis`` (JAX: usable under ``shard_map`` with the stage
    parameters split over ``axis``).
    """

    def f(comm, stage_params, x_micro, labels_micro):
        p = comm.axis_size(axis)
        last = torch.tensor(comm.axis_index(axis) == p - 1, device=x_micro.device)
        outs = pipeline_forward(comm, stage_fn, stage_params, x_micro, axis)
        loss = final_fn(outs, labels_micro)
        # only the last stage's loss is real; broadcast it
        loss = torch.where(last, loss, torch.zeros_like(loss))
        return comm.psum(loss, axis)

    return f


def make_pipelined_value_and_grad(stage_fn, final_fn, axis: str):
    """The value and stage gradients of ``make_pipelined_loss``, with no collective
    inside autograd (the module docstring).

    Returns f(comm, stage_params, x_micro, labels_micro) -> (loss, grads): the
    loss on every rank of ``axis``, and this rank's gradient of it with respect
    to every leaf of ``stage_params`` (a tree of the same structure).  The
    caller's tensors are not changed.  ``final_fn`` runs on the last stage
    only: the other stages' losses are masked to zero, whatever they are, so
    it returns a float32 scalar (the zeros' type), as ``cross_entropy`` does.
    """

    def f(comm, stage_params, x_micro, labels_micro):
        m = x_micro.shape[0]
        p, idx, fwd, ticks = _schedule(comm, axis, m)
        back = [(b, a) for a, b in fwd]
        first, last = idx == 0, idx == p - 1
        flat, spec = tree_lib.flatten(stage_params)
        views = [t.detach().requires_grad_(True) for t in flat]
        params = tree_lib.unflatten(spec, views)

        inputs = []
        with torch.no_grad():
            state = torch.zeros_like(x_micro[0])
            outputs = torch.zeros_like(x_micro)
            for t in range(ticks):
                x_in = x_micro[min(t, m - 1)] if first else state
                inputs.append(x_in)
                y = stage_fn(params, x_in)
                if last and t >= p - 1:
                    outputs[t - (p - 1)] = y
                state = comm.ppermute(y, axis, fwd)

        g_out = None
        if last:
            with torch.enable_grad():
                outs = outputs.requires_grad_(True)
                loss = final_fn(outs, labels_micro)
                (g_out,) = torch.autograd.grad(loss, outs)
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=x_micro.device)
        loss = comm.psum(loss, axis)

        g_state = torch.zeros_like(x_micro[0])  # the last tick's handoff feeds nothing
        for t in reversed(range(ticks)):
            g_y = comm.ppermute(g_state, axis, back)
            if last and t >= p - 1:
                g_y = g_y + g_out[t - (p - 1)]
            x_in = inputs[t].detach().requires_grad_(not first)
            with torch.enable_grad():
                y = stage_fn(params, x_in)
            # the stage gradients add up in place in .grad, tick after tick
            torch.autograd.backward(y, g_y, inputs=views + ([] if first else [x_in]))
            # stage 0's input is the microbatch, not a handoff
            g_state = torch.zeros_like(g_state) if first else x_in.grad
            inputs[t] = None
        grads = [torch.zeros_like(v) if v.grad is None else v.grad for v in views]
        return loss, tree_lib.unflatten(spec, grads)

    return f
