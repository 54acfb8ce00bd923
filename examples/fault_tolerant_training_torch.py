"""The paper's fault-tolerance loop through the PyTorch port: train -> board
failure -> allocator remap -> checkpoint restore -> continue (paper §III-E / §IV-A).

The twin of ``examples/fault_tolerant_training.py`` over
``repro_torch.launch.train``, on the GPU unless ``--device cpu`` is given;
other flags pass through to the driver (given twice, the later wins).

  PYTHONPATH=src python examples/fault_tolerant_training_torch.py
  PYTHONPATH=src python examples/fault_tolerant_training_torch.py --device cpu
"""

import sys
import tempfile

from repro_torch.launch import train


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as d:
        return train.main(["--arch", "llama3.2-3b-smoke", "--steps", "40",
                           "--checkpoint-dir", d, "--checkpoint-every", "10",
                           "--simulate-failure", "25", *argv])


if __name__ == "__main__":
    main()
