"""Quickstart through the PyTorch port: the paper's pieces in 60 lines.

The twin of ``examples/quickstart.py`` over ``repro_torch``; part 4 trains on
the GPU unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/quickstart_torch.py              # on the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

import argparse

import torch

# 1. HammingMesh topology analytics (paper §III, Table II) ------------------
from repro_torch.core.topology import FatTree, HxMesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    hx = HxMesh(a=2, b=2, x=16, y=16)          # 1,024-accelerator Hx2Mesh
    ft = FatTree(1024, taper=0.0)
    print(f"Hx2Mesh: {hx.num_accelerators} accels, cost ${hx.structure().cost_musd:.1f}M, "
          f"bisection {hx.bisection_fraction:.2f}, diameter {hx.diameter}")
    print(f"nonblocking fat tree costs ${ft.structure().cost_musd:.1f}M "
          f"({ft.structure().cost / hx.structure().cost:.1f}x more)")

    # 2. Job allocation with failures (paper §IV) ----------------------------
    from repro_torch.core.allocation import HxMeshAllocator, Job

    alloc = HxMeshAllocator(16, 16)
    alloc.fail_board(3, 5)
    pl = alloc.allocate(Job(0, 4, 4), transpose=True)
    print(f"4x4 job -> virtual sub-HxMesh rows={pl.rows[:4]} cols={pl.cols[:4]}")

    # 3. The paper's collective algorithms: which one the alpha-beta model picks
    from repro_torch.core.commodel import best_algorithm

    for size in (1e5, 1e9):
        name, t = best_algorithm(p=64, size_bytes=size)
        print(f"allreduce of {size:.0e} B on 64 devices -> {name} ({t*1e6:.0f} us)")

    # 4. Train a tiny model through the full stack ---------------------------
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.device import resolve_device
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps

    device = resolve_device(args.device)
    cfg = get_config("llama3.2-3b-smoke")
    params = get_model(cfg).init_params(cfg, torch.Generator(device).manual_seed(0),
                                        dtype=torch.float32)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    step = steps.make_train_step(cfg, ocfg, steps.TrainOptions(remat=False))
    ostate = opt.init(params)
    loss = None
    for s in range(20):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in make_batch(cfg, 32, 4, step=s).items()}
        params, ostate, m = step(params, ostate, batch)
        loss = float(m["loss"])
        if s % 5 == 4:
            print(f"step {s+1:2d}  loss {loss:.3f}")
    print("quickstart OK")
    return loss


if __name__ == "__main__":
    main()
