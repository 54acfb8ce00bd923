"""The messages and bytes of the paper's allreduce algorithms through the port
(the twin of ``_compute_hlo`` in ``benchmarks/fig13_allreduce.py``).

  PYTHONPATH=src python benchmarks/fig13_allreduce_torch.py [--device cpu]

For psum, ring, bidir, torus and hamiltonian, one allreduce of 4 MiB (2^20
float32) over a 4 × 4 ``LocalMesh`` of rank threads (on the GPU unless
``--device cpu``), every rank's counts from the mesh's ``CommStats``: its
ppermute messages and bytes sent, and its psum calls.  Those are the
counterparts of the compiled HLO's collective-permute and all-reduce counts;
the rings move their data by ppermute alone (0 psum calls).

The numbers differ from the JAX twin's: XLA's HLO text holds a ``fori_loop``
body once, so a ring's collective-permutes count once a loop, while
``CommStats`` counts every send that runs: the 3 reduce-scatter and 3
all-gather steps of each 4-rank ring, and each ring of the bidirectional,
torus and Hamiltonian schedules.
"""

import argparse
import json

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.comm import LocalMesh
from repro_torch.device import resolve_device

SIZE = 1 << 20  # float32 elements: 4 MiB
ALGOS = ("psum", "ring", "bidir", "torus", "hamiltonian")


def measure(device=None) -> list[dict]:
    """One row an algorithm: per-rank messages, bytes and psum calls (each the
    same on every rank, else the row says so), and the result's error."""
    dev = resolve_device(device)
    mesh = LocalMesh((4, 4), ("data", "model"), dev)
    xs = [torch.full((SIZE,), float(r + 1), device=dev) for r in range(mesh.size)]
    want = float(sum(range(1, mesh.size + 1)))
    rows = []
    for algo in ALGOS:
        mesh.stats.reset()
        outs = mesh.run(lambda comm, x, a=algo: coll.allreduce(comm, x, a, ("data", "model"),
                                                               (4, 4)), xs)
        err = max(float((o - want).abs().max()) for o in outs)
        msgs = [sum(n for (s, _), n in mesh.stats.messages.items() if s == r)
                for r in range(mesh.size)]
        sent = [sum(b for (s, _), b in mesh.stats.bytes.items() if s == r)
                for r in range(mesh.size)]
        rows.append({"algo": algo, "permutes_per_rank": max(msgs),
                     "bytes_per_rank": max(sent), "uniform": min(msgs) == max(msgs)
                     and min(sent) == max(sent),
                     "psum_calls_per_rank": mesh.stats.psum_calls / mesh.size,
                     "max_abs_err": err})
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows = measure(args.device)
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
