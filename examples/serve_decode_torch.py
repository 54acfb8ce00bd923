"""Batched-decoding example over the SSM arch through the PyTorch port (``repro_torch``).

The twin of ``examples/serve_decode.py`` over ``repro_torch.launch.serve``:
the same arch and sizes (mamba2-130m-smoke, batch 4, a 16-token prompt, 32
decoded: a constant-size recurrent state), on the GPU unless ``--device cpu``
is given; any other flag passes through to the server.

  PYTHONPATH=src python examples/serve_decode_torch.py              # on the GPU
  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""

import sys

from repro_torch.launch import serve

DEFAULTS = (("--arch", "mamba2-130m-smoke"), ("--batch", "4"), ("--prompt-len", "16"),
            ("--decode", "32"))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag, value in DEFAULTS:
        if not any(a.startswith(flag) for a in argv):
            argv += [flag, value]
    return serve.main(argv)


if __name__ == "__main__":
    main()
