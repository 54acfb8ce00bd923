"""End-to-end training driver with checkpoint/restart and failure simulation.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b-smoke \
      --steps 60 --simulate-failure 25 --checkpoint-dir CKPT [--device cpu]

The same CLI, loop and printout as ``repro.launch.train``: config → data
pipeline → train step → periodic checkpointing → simulated board failure →
allocation-layer remap → restore-and-continue.  It runs on the GPU unless
``--device cpu`` is given.  The weights come from
``torch.Generator(device).manual_seed(seed)``, so their numbers differ from
the JAX version's; the batches are the same.  ``--sync`` other than ``auto``
reduces the gradients with one of the paper's algorithms over a 1D
``"data"`` mesh, as the JAX driver does over ``jax.devices()``:

* in one process, of this process's devices: every visible GPU (a
  ``LocalMesh``, one rank a GPU), or one rank with ``--device cpu``;
* under ``torchrun`` (``WORLD_SIZE`` set), of the processes: a ``DistMesh``
  with one rank a process, over NCCL on this process's GPU
  (``LOCAL_RANK``), or over gloo with ``--device cpu``.  Each process takes
  its shard of the batch; only rank 0 prints and writes checkpoints.

  torchrun --standalone --nproc_per_node N -m repro_torch.launch.train \
      --sync ring [--device cpu] ...

On a 1D mesh ``torus`` and ``hamiltonian`` raise ("needs a 2D mesh"), as in
JAX; ``--compress-k`` takes effect with a sync mode only.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.core import allocation as alloc_lib
from repro_torch.core.comm import DistMesh, LocalMesh
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import local_devices
from repro_torch.models import get_model
from repro_torch.parallel.sharding import Policy
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import steps as steps_lib


def build(args, device: torch.device):
    cfg = get_config(args.arch)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device).manual_seed(args.seed),
                               dtype=torch.float32)
    ocfg = opt_lib.AdamWConfig(
        lr=args.lr, warmup_steps=max(1, args.steps // 10),
        total_steps=args.steps, schedule=cfg.schedule,
    )
    options = steps_lib.TrainOptions(sync=args.sync, remat=not args.no_remat,
                                     compress_k=args.compress_k, use_kernel=args.use_kernel)
    mesh = None
    if args.sync != "auto" and dist.is_initialized():
        mesh = DistMesh((dist.get_world_size(),), ("data",), device)
    elif args.sync != "auto":
        devices = local_devices(device)
        mesh = LocalMesh((len(devices),), ("data",), devices)
    step_fn = steps_lib.make_train_step(cfg, ocfg, options, Policy(data_axes=("data",)), mesh)
    return cfg, params, opt_lib.init(params), step_fn


def main(argv=None):
    """Run the driver; returns the last step's metrics as Python floats and the step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b-smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync", default="auto")
    ap.add_argument("--compress-k", type=int, default=0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--use-kernel", action="store_true",
                    help="attention through the flash kernel (TrainOptions.use_kernel); "
                         "off by default, as in the JAX driver")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="board failure at this step (needs --checkpoint-dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ:  # under torchrun: one rank a process
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    try:
        return _run(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device):
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg, params, opt_state, step_fn = build(args, device)
    start = 0
    if args.checkpoint_dir:
        restored, rstep = ckpt_lib.restore_latest(
            args.checkpoint_dir, {"p": params, "o": opt_state})
        if restored is not None:
            params, opt_state = restored["p"], restored["o"]
            start = rstep
            say(f"[train] resumed from step {start}")

    # the job's boards on a small HxMesh (the paper's allocation layer)
    allocator = alloc_lib.HxMeshAllocator(8, 8)
    placement = allocator.allocate(alloc_lib.Job(0, 2, 4), transpose=True)
    say(f"[train] job placed on boards rows={placement.rows} cols={placement.cols}")

    t0 = time.time()
    step = start
    metrics = {}
    while step < args.steps:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in make_batch(cfg, args.seq, args.batch, step=step,
                                        seed=args.seed).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        step += 1
        if step % 10 == 0 or step == args.steps:
            say(f"[train] step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.time() - t0):.1f}s)")
        if args.checkpoint_dir and step % args.checkpoint_every == 0:
            if lead:
                ckpt_lib.save_step(args.checkpoint_dir, {"p": params, "o": opt_state}, step)
            if dist.is_initialized():
                dist.barrier()

        if args.simulate_failure and step == args.simulate_failure:
            # -- the paper's fault-tolerance loop (§III-E, §IV) --------------
            r, c = placement.boards[0]
            say(f"[failure] board ({r},{c}) failed — evicting job")
            allocator.fail_board(r, c)
            new_pl = alloc_lib.remap_after_failure(
                allocator, alloc_lib.Job(0, 2, 4), transpose=True, aspect=True)
            if new_pl is None:
                raise RuntimeError("no spare virtual sub-HxMesh")
            if not alloc_lib.is_virtual_subhxmesh(new_pl.boards):
                raise RuntimeError(f"remap is not a virtual sub-HxMesh: {new_pl.boards}")
            placement = new_pl
            say(f"[failure] remapped to rows={new_pl.rows} cols={new_pl.cols}")
            if not args.checkpoint_dir:
                raise ValueError("failure simulation needs checkpoints (--checkpoint-dir)")
            cfg, params, opt_state, step_fn = build(args, device)
            restored, rstep = ckpt_lib.restore_latest(
                args.checkpoint_dir, {"p": params, "o": opt_state})
            if restored is None:
                raise RuntimeError(f"no checkpoint in {args.checkpoint_dir} to restart from")
            params, opt_state = restored["p"], restored["o"]
            step = rstep
            say(f"[failure] restarted from checkpoint step {rstep}")
            args.simulate_failure = 0  # only once

    say(f"[train] done: {args.steps} steps in {time.time() - t0:.1f}s")
    return {"step": step, **{k: float(v) for k, v in metrics.items()}}


if __name__ == "__main__":
    main()
