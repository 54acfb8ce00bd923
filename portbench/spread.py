"""Runs of one cell, one process each, and the spread of their metrics.

    python3 portbench/spread.py --workload <name> --seeds 1,2,3 [--trace 1] [--seconds s]

Each run is ``portbench/run.py`` as the benchmark's command runs it; its
result line goes to ``results/portbench/runs-<workload>.jsonl``. At the end, for
every metric: the values in order, their median, and the distance between
the first and third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--seconds", type=float,
                   default=json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"])
    args = p.parse_args(argv)
    out_dir = ROOT / "results" / "portbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    results, failed = [], 0
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", args.workload,
               "--seed", seed, "--seconds", str(args.seconds), "--trace", str(args.trace)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t0
        if proc.returncode:
            failed += 1
            print(f"seed {seed}: exit {proc.returncode} after {wall:.1f} s\n{proc.stderr[-3000:]}",
                  flush=True)
            continue
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        result["seed"], result["wall_s"] = int(seed), wall
        results.append(result)
        with open(out_dir / f"runs-{args.workload}.jsonl", "a") as f:
            f.write(json.dumps(result) + "\n")
        print(json.dumps(result), flush=True)
    names = sorted({n for r in results for n in r["metrics"]})
    for name in names:
        values = [r["metrics"][name]["value"] for r in results if name in r["metrics"]]
        if len(values) >= 2:
            print(f"{name}: median {statistics.median(values)!r} spread {spread(values)!r} "
                  f"values {values}", flush=True)
    print(f"correct {sum(r['correct'] for r in results)} of {len(results)}, failed {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
