"""Batched serving: prefill a prompt batch, then autoregressive decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b-smoke \
      --batch 4 --prompt-len 32 --decode 64 [--device cpu]

The same loop and printout as ``repro.launch.serve``.  It runs on the GPU
unless ``--device cpu`` is given.  The weights come from
``torch.Generator(device).manual_seed(0)``, so their numbers differ from the
JAX version's ``jax.random.PRNGKey(0)``; the prompts are the same.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.train import steps as steps_lib


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, params, prompts: torch.Tensor, n_decode: int) -> dict:
    """Teacher-force ``prompts`` (B, P) through the decode step, then decode greedily.

    Returns the decoded tokens (B, n_decode) and the wall-clock seconds of the
    prompt and decode phases, each ending in a device sync.
    """
    model = get_model(cfg)
    device = prompts.device
    batch, prompt_len = prompts.shape
    cache = model.init_cache(cfg, batch, prompt_len + n_decode,
                             dtype=params["embed"].dtype, device=device)
    serve_step = steps_lib.make_decode_step(cfg)
    # prefill via repeated decode steps (teacher-forced), as the JAX version does;
    # make_prefill_step is the single-forward prefill.
    _sync(device)
    t0 = time.perf_counter()
    tok = None
    for t in range(prompt_len):
        tok, cache = serve_step(params, cache, prompts[:, t:t + 1])
    _sync(device)
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = []
    for _ in range(n_decode):
        tok, cache = serve_step(params, cache, tok)
        out.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s, "decode_s": decode_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device).manual_seed(0))
    prompts = torch.from_numpy(make_batch(cfg, args.prompt_len, args.batch)["tokens"])
    res = serve(cfg, params, prompts.to(device), args.decode)
    toks_per_s = args.batch * args.decode / res["decode_s"]
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill {args.prompt_len} toks in {res['prefill_s']:.2f}s; "
          f"decoded {args.decode} toks/seq in {res['decode_s']:.2f}s "
          f"({toks_per_s:.1f} tok/s)")
    print(f"[serve] sample continuation: {res['tokens'][0, :16].tolist()}")


if __name__ == "__main__":
    main()
