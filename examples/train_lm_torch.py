"""End-to-end LM training example through the PyTorch port (``repro_torch``).

The twin of ``examples/train_lm.py`` over ``repro_torch.launch.train``: the
same defaults (minicpm-2b-smoke, 50 steps), on the GPU unless ``--device cpu``
is given; any other flag passes through to the driver.

  PYTHONPATH=src python examples/train_lm_torch.py              # on the GPU
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 300
"""

import sys

from repro_torch.launch import train


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--arch") for a in argv):
        argv = ["--arch", "minicpm-2b-smoke"] + argv
    if not any(a.startswith("--steps") for a in argv):
        argv += ["--steps", "50"]
    return train.main(argv)


if __name__ == "__main__":
    main()
