"""The readings that a cell's limits are set from, on the card at the cell's size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--what program,control]

For every seed, one line of JSON on standard output (and in
``results/portbench/control-<workload>.jsonl``) with the compared numbers of:

- ``program``: the program's timed path against the reference, as a run
  compares them (training: the first steps; prefill: the program's first
  token of the rows a window would check, each served in its whole call);
- ``control``: the reference in the next precision below the configuration's
  in the program's place (TF32 for float32 with TF32 off; float8 e4m3 for
  bf16);
- training only, ``half_batch``: the reference in the program's place on
  half of each batch, the mean taken over the rest. A state left unchanged
  reads 1 on ``change_gap`` by its definition and needs no run.

In a training cell with experts the float32 reference that judges a side
takes that side's routing choices, as a run's check takes the program's.

The limits in ``limits/<cell>.json`` lie between the largest ``program``
reading and the least of the others (see PERF.md).
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class HalfFeed:
    """A feed whose batches keep the first half of their rows."""

    def __init__(self, feed):
        self.feed = feed

    def batch(self, index: int) -> dict:
        from portbench import feed

        b = self.feed.batch(index)
        return feed.rows(b, slice(b["tokens"].shape[0] // 2))


def readings(harness, cell, seed: int, what: set, device) -> dict:
    from portbench import check, feed
    from portbench.reference import model as ref

    import torch

    r = harness.Run(cell, seed, 0.0, False, device, time.perf_counter())
    fp32, lower = ref.Precision("fp32"), ref.Precision(
        "tf32" if cell.config["torch_dtype"] == "float32" else "fp8")
    out = {"seed": seed}
    program = "program" in what
    if cell.mix["kind"] == "train":
        if program:
            r.setup_train()  # the step, weights and moments go when it returns
        torch.cuda.empty_cache()
        ref.no_tf32()
        first, ocfg = cell.mix["first_steps"], dataclasses.asdict(_adamw())

        def judged(side: dict) -> dict:
            refs = check.train_reference(r.arch, r.make_weights, r.feed, first, ocfg,
                                         cell.aux_weight, fp32, side["route"])
            return check.train_numbers(side, refs)

        if program:
            out["program"] = judged(r.prog)
        for name, source, prec in (("control", r.feed, lower),
                                   ("half_batch", HalfFeed(r.feed), fp32)):
            if name not in what:
                continue
            out[name] = judged(check.train_reference(r.arch, r.make_weights, source, first,
                                                     ocfg, cell.aux_weight, prec))
        return out
    picks = r.checked_rows(int(cell.mix["rate_per_s"] * _seconds()))  # as if every call due ran
    requests = [feed.rows(r.feed.batch(k), rows) for k, rows in picks]
    if program:
        r.setup_prefill()
        served = [r.serve(r.feed.batch(k))[rows] for k, rows in picks]
        del r.step
    else:
        r.params = r.make_weights()
    torch.cuda.empty_cache()
    ref.no_tf32()
    if program:
        t0 = time.perf_counter()
        out["program_gaps"] = check.logit_gaps(r.arch, r.params, requests, served, fp32)
        out["program"] = {"logit_gap": max(out["program_gaps"])}
        out["reference_s"] = time.perf_counter() - t0
    if "control" in what:
        out["control_gaps"] = check.logit_gaps(r.arch, r.params, requests,
                                               [None] * len(requests), fp32, pick=lower)
        out["control"] = {"logit_gap": max(out["control_gaps"])}
    return out


def _adamw():
    from repro_torch.train import optimizer as opt

    return opt.AdamWConfig()


def _seconds() -> float:
    return json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--what", default="program,control,half_batch",
                   help="comma-separated readings: program, control, half_batch")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    run.prepare()

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("the controls run on a CUDA device; there is none", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out_dir = ROOT / "results" / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"control-{args.workload}.jsonl", "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps(readings(harness, cell, seed, set(args.what.split(",")), "cuda"))
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
