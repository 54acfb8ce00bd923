"""The collectives GSPMD puts in the JAX package's jitted serving steps under
``param_specs``' 2D layout: an arch at full width (llama3.2-3b unless ``--arch``
names another, such as moonshot-v1-16b-a3b for the MoE layer's), ``--layers``
layers (1 by default; recurrentgemma-9b needs 3, one (rec, rec, attn) block), on
a mesh of (data, model) = (1, 16) host devices.  ``--smoke`` takes the arch's
smoke twin, a quick check of the script itself.

The prefill step (B 4 x 2048) and the decode step (B 4, a cache of 2048) are
jitted with ``in_shardings`` as ``repro.launch.dryrun.build_cell`` jits them,
lowered, compiled for the CPU, and every collective of the compiled HLO is
printed with its result shape and replica groups.  The port's tensor-parallel
serving (``repro_torch/parallel/tensor_parallel.py``) computes the same
function with a re-layout of its own; ``chip_smoke.py`` prints these lines
beside its own collectives.  XLA's CPU backend may upcast bf16 dots to f32, so
the dtypes are not evidence about a TPU.

  PYTHONPATH=src python benchmarks/gspmd_tp_collectives.py [--arch recurrentgemma-9b --layers 3]
"""

from __future__ import annotations

import os
import re
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=16").strip()

BATCH, SEQ = 4, 2048
KINDS = ("all-reduce", "all-gather", "all-to-all", "collective-permute", "reduce-scatter")
_KIND = re.compile(r"=\s*(\(.*?\)|\S+)\s+(" + "|".join(KINDS) + r")(-start)?\(")
_SHAPE = re.compile(r"[a-z0-9]+\[[0-9,]*\]")
_GROUPS = re.compile(r"replica_groups=(\[[0-9,]*\]<=\[[0-9,]*\](?:T\([0-9,]*\))?"
                     r"|\{(?:\{[0-9,]*\},?)*\})")


def collectives(hlo: str) -> list[str]:
    """One line a collective of the compiled module: its kind, its result's shapes
    (a tuple's each) and its replica groups."""
    out = []
    for line in hlo.splitlines():
        m = _KIND.search(line)
        if not m:
            continue
        shapes = _SHAPE.findall(m.group(1))
        groups = _GROUPS.search(line)
        out.append(f"{m.group(2)} {' '.join(shapes)}"
                   + (f" groups {groups.group(1)}" if groups else ""))
    return out


def main() -> int:
    import argparse
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.configs import abstract_params, get_config
    from repro.launch import compat
    from repro.models import get_model
    from repro.parallel import sharding as sh
    from repro.train import steps

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    cfg = dataclasses.replace(get_config(args.arch, smoke=args.smoke), n_layers=args.layers)
    mesh = compat.make_mesh((1, 16), ("data", "model"))
    policy = sh.default_policy(cfg)
    params = abstract_params(cfg)
    pshard = sh.to_shardings(mesh, sh.sanitize_specs(
        params, sh.param_specs(cfg, params, policy), mesh))
    tshard = NamedSharding(mesh, sh.batch_specs(cfg, policy, mesh, BATCH)["tokens"])
    act = sh.activation_specs(cfg, policy, mesh, BATCH)
    act["mesh"] = mesh
    prefill = jax.jit(steps.make_prefill_step(cfg, steps.TrainOptions(), act_specs=act),
                      in_shardings=(pshard, {"tokens": tshard}))
    tokens = jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32)
    cache = jax.eval_shape(lambda: get_model(cfg).init_cache(cfg, BATCH, SEQ))
    cshard = sh.to_shardings(mesh, sh.cache_specs(cfg, cache, policy, mesh, BATCH))
    decode = jax.jit(steps.make_decode_step(cfg), in_shardings=(pshard, cshard, tshard))
    one = jax.ShapeDtypeStruct((BATCH, 1), jnp.int32)
    print(f"jax {jax.__version__}, {len(jax.devices())} {jax.devices()[0].platform} devices; "
          f"{cfg.name} at {cfg.n_layers} layers, mesh (data, model) = (1, 16), {policy}")
    for name, fn, args in (("prefill", prefill, (params, {"tokens": tokens})),
                           ("decode", decode, (params, cache, one))):
        lines = collectives(fn.lower(*args).compile().as_text())
        print(f"{name} B {BATCH} x {SEQ if name == 'prefill' else 1}: {len(lines)} collectives")
        for line in lines:
            print("  " + line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
