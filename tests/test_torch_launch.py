"""The train CLI under torchrun, on the CPU.

``torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train
--sync ring --device cpu`` runs one rank a process: the CLI initialises a
gloo process group and builds a ``DistMesh((2,), ("data",))``, and each
process takes its half of the batch.  Its checkpoint (written by rank 0) must
equal, bit for bit, that of the same CLI in one process over a ``LocalMesh``
of 2 CPU rank threads: the same shards, the same ring, transports that only
copy.  The failure, remap and restore loop runs under torchrun too.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "llama3.2-3b-smoke", "--steps", "6", "--batch", "4", "--seq", "16",
        "--sync", "ring", "--device", "cpu", "--checkpoint-every", "3"]


def _torchrun(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "repro_torch.launch.train", *args]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    return proc.stdout


@pytest.mark.timeout(300)
def test_torchrun_over_two_gloo_processes_matches_two_rank_threads(tmp_path, monkeypatch,
                                                                   capsys):
    out = _torchrun([*ARGS, "--checkpoint-dir", str(tmp_path / "dist")])
    assert out.count("[train] step    6") == 1  # rank 0 alone prints
    monkeypatch.setattr(train_cli, "local_devices", lambda device: [torch.device("cpu")] * 2)
    train_cli.main([*ARGS, "--checkpoint-dir", str(tmp_path / "local")])
    capsys.readouterr()
    for step in (3, 6):
        dist_dir, local_dir = (str(tmp_path / k / f"step_{step}") for k in ("dist", "local"))
        leaves = tree_lib.leaves(ckpt.restore(local_dir, _target(local_dir))[0])
        got = tree_lib.leaves(ckpt.restore(dist_dir, _target(dist_dir))[0])
        assert len(got) == len(leaves)
        for a, b in zip(got, leaves):
            assert torch.equal(a, b)


def _target(directory):
    """A flat target of the checkpoint's own leaves (their shapes are all restore reads)."""
    with open(os.path.join(directory, "manifest.json")) as f:
        n = json.load(f)["n_leaves"]
    return tuple(torch.empty(np.load(os.path.join(directory, f"leaf_{i:05d}.npy"),
                                     mmap_mode="r").shape) for i in range(n))


@pytest.mark.timeout(300)
def test_torchrun_failure_remap_and_restore(tmp_path):
    out = _torchrun([*ARGS, "--checkpoint-dir", str(tmp_path), "--simulate-failure", "5"])
    assert "[failure] restarted from checkpoint step 3" in out
    assert out.count("[train] done: 6 steps") == 1
