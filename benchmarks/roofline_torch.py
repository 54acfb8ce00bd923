"""Roofline analysis from the port's dry-run JSON, on H100 constants (the twin
of ``benchmarks/roofline.py``, which reads the JAX dry-run's TPU numbers).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single
  PYTHONPATH=src python benchmarks/roofline_torch.py [PATH]

Hardware constants: NVIDIA H100 SXM5 80GB at its 700 W power limit, the data
sheet's dense rates:
  peak_flops = 989 TFLOP/s bf16 / GPU
  hbm_bw     = 3.35 TB/s HBM3 / GPU
  link_bw    = 450 GB/s NVLink / GPU, each direction

Per (arch × shape × mesh) cell, all numbers a rank (the dry-run traces rank 0):
  compute term    = FLOPs / peak_flops
  memory term     = bytes_accessed / hbm_bw (unfused aten bytes: an upper bound)
  collective term = collective_wire_bytes / link_bw
  MODEL_FLOPS     = 6·N·D (dense) or 6·N_active·D per train step
                    (2·N·D for inference steps), split over the chips
  usefulness      = MODEL_FLOPS / FLOPs

Every rank of the port runs the whole model on its data shard, so a rank's
FLOPs hold the compute that the ``model`` axis replicates (16 ranks on the
single pod): a useful fraction near 1/16 is the port's layout, not a fault.
Only the standard library and ``repro_torch`` are imported.
"""

import json
import sys

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES

DRYRUN_PATH = "results/dryrun_torch.json"

HARDWARE = "NVIDIA H100 SXM5 80GB, 700 W"  # the data sheet's part and power limit
PEAK_FLOPS = 989e12  # bf16 dense, tensor cores
HBM_BW = 3.35e12  # HBM3
LINK_BW = 450e9  # NVLink 4, one direction, the GPU's 18 links together


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def terms(flops: float, nbytes: float, wire: float) -> dict:
    """Seconds of a rank's compute, memory and collective terms."""
    return {"compute": flops / PEAK_FLOPS, "memory": nbytes / HBM_BW,
            "collective": wire / LINK_BW}


def analyse(rec: dict) -> dict:
    """The three terms of one dry-run record, the dominant one, and the useful
    and roofline fractions (``benchmarks/roofline.py::analyse``)."""
    chips = rec["chips"]
    flops = rec["flops"]
    terms_ = terms(flops, rec["bytes_accessed"], rec.get("collective_wire_bytes", 0))
    dominant = max(terms_, key=terms_.get)
    mf = model_flops(rec["arch"], rec["shape"]) / chips
    useful = mf / flops if flops else 0.0
    bound = max(terms_.values())
    # roofline fraction: useful work per chip / peak, at the modeled step time
    frac = (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return {
        **{f"t_{k}": v for k, v in terms_.items()},
        "dominant": dominant,
        "model_flops_per_chip": mf,
        "useful_fraction": useful,
        "roofline_fraction": frac,
    }


def row(rec: dict) -> dict:
    """One printed row of a record: its terms in seconds, or ``failed``."""
    if not rec.get("ok"):
        return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
                "failed": True}
    a = analyse(rec)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "sync": rec.get("sync", "auto"),
        "compute_s": round(a["t_compute"], 4),
        "memory_s": round(a["t_memory"], 4),
        "collective_s": round(a["t_collective"], 4),
        "dominant": a["dominant"],
        "useful": round(a["useful_fraction"], 4),
        "roofline": round(a["roofline_fraction"], 4),
        "peakGB": round(rec["peak_bytes_per_rank"] / 1e9, 1),
    }


def main(argv=None) -> list[dict]:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else DRYRUN_PATH
    with open(path) as f:
        records = json.load(f)
    print(f"# {HARDWARE}: {PEAK_FLOPS / 1e12:g} TFLOP/s bf16, {HBM_BW / 1e12:g} TB/s HBM, "
          f"{LINK_BW / 1e9:g} GB/s NVLink")
    rows = [row(r) for r in records]
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
