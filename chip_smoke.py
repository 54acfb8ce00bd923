"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

  python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with nvcc (sm_90a), holds each against its plain PyTorch version on the card,
then serves llama3.2-3b at full width with random weights from a seed:

1. device and toolchain: card name and power limit, torch and nvcc versions;
2. build, timed;
3. flash_attention_fwd against its plain version at every shape of the JAX
   package's kernel tests and at the llama3.2-3b prefill shape, fp32 and bf16,
   with its time, the plain version's, SDPA's (a yardstick only) and its bound;
4. a full-width bf16 prefill (batch 4, prompt 2048) through
   ``make_prefill_step(use_kernel=True)``: the kernel launches once a layer;
5. the same prefill in fp32 at batch 1 with and without the kernel;
6. the serving loop of ``repro_torch.launch.serve`` (batch 4, prompt 128,
   32 decoded) in bf16, timed; then the decode loop's last prompt-step
   logits against the prefill step's on the same prompt, held in fp32 and
   measured in bf16;
7. one JSON line on every kernel, the card's name and power limit, and last
   the JSON result line.

Any failure raises and exits nonzero; without a CUDA device, or without the
rest of the repository beside it, the script exits nonzero and prints no
result.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense), for the bound.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # those of tests/test_kernels.py
# (b, sq, sk, h, kv, d, causal, window): the shapes of tests/test_kernels.py CASES,
# then a few more
CASES = [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 4, 1, 64, False, 0),
    (1, 256, 256, 8, 2, 32, True, 64),
    (1, 200, 200, 2, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 128, True, 0),
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 128, 128, 2, 1, 64, False, 32),
    # head_dim 16 and 8 of the smoke archs, ragged lengths, Sq > Sk (every
    # row keeps a key: rows with none have no defined answer, the JAX kernel's
    # and its reference's differ there)
    (2, 70, 70, 4, 2, 16, True, 0),
    (1, 33, 33, 2, 1, 8, True, 0),
    (1, 100, 60, 4, 2, 32, True, 0),
    (1, 96, 200, 4, 2, 64, True, 48),
]
PREFILL_BATCH, PREFILL_LEN = 4, 2048
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = 4, 128, 32
# Relative L2 error of fp32 logits between two paths of the full model (the
# prefill with and without the kernel; the decode loop and the prefill): both
# sum in fp32, in different orders, through 28 layers.
FP32_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    from repro_torch.kernels import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"[device] torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: {nvcc}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(_build.sources())} source(s), {len(logs)} compiled in "
        f"{time.perf_counter() - t0:.1f}s into {_build.BUILD_DIR.relative_to(ROOT)}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _qkv(b, sq, sk, h, kv, d, dtype, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)


def _attention_bound_ms(q, k, v, causal, window) -> tuple[float, str]:
    """Least time for the work these inputs need: unmasked (q, k) pairs and bytes."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qpos = torch.arange(sq, device="cuda")[:, None]
    kpos = torch.arange(sk, device="cuda")[None, :]
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    flops = 4.0 * b * h * d * int(keep.sum())  # q·k and p·v, 2 flops a multiply-add
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * q.element_size()  # q, k, v in; o out
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernel_checks() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for case in CASES:
            *shape, causal, window = case
            q, k, v = _qkv(*shape, dtype, gen)
            got = fa.flash_attention_fwd(q, k, v, causal, window)
            want = fa.plain(q, k, v, causal, window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            bad = err > TOL[dtype] * (1 + want.float().abs())
            if bad.any():
                raise AssertionError(f"flash_attention_fwd {case} {dtype}: max_abs_err "
                                     f"{float(err.max()):.3e} over tolerance {TOL[dtype]}")
            worst = max(worst, float(err.max()))
        log(f"[kernel] flash_attention_fwd {dtype}: {len(CASES)} test shapes within "
            f"{TOL[dtype]} (max_abs_err {worst:.3e})")

    b, s = PREFILL_BATCH, PREFILL_LEN
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _qkv(b, s, s, 24, 8, 128, dtype, gen)
        got = fa.flash_attention_fwd(q, k, v, True, 0)
        want = fa.plain(q, k, v, True, 0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if (err > TOL[dtype] * (1 + want.float().abs())).any():
            raise AssertionError(f"flash_attention_fwd prefill shape {dtype}: max_abs_err "
                                 f"{float(err.max()):.3e} over tolerance {TOL[dtype]}")
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        if (sdpa.transpose(1, 2).float() - want.float()).abs().max() > 10 * TOL[dtype]:
            raise AssertionError("SDPA yardstick does not compute the same function")
        bound_ms, bound_by = _attention_bound_ms(q, k, v, True, 0)
        r = {
            "max_abs_err": float(err.max()),
            "ms": cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, True, 0)),
            "plain_ms": cuda_ms(lambda: fa.plain(q, k, v, True, 0), reps=5),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        log(f"[kernel] flash_attention_fwd prefill shape B={b} S={s} H=24 KV=8 D=128 causal "
            f"{dtype}: max_abs_err {r['max_abs_err']:.3e} kernel_ms {r['ms']:.4f} "
            f"plain_ms {r['plain_ms']:.4f} library_ms(SDPA) {r['library_ms']:.4f} "
            f"bound_ms {bound_ms:.4f} ({bound_by})")
        results[dtype] = r
        del q, k, v, qt, kt, vt, got, want, sdpa, err
    torch.cuda.empty_cache()
    return results[torch.bfloat16]  # the main path runs bf16


def _prefill(cfg, params, tokens, use_kernel: bool):
    from repro_torch.train.steps import TrainOptions, make_prefill_step

    step = make_prefill_step(cfg, TrainOptions(use_kernel=use_kernel))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    return logits, time.perf_counter() - t0


def phase_prefill(cfg, params, smi) -> dict:
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attention as fa

    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, PREFILL_BATCH)["tokens"]).cuda()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0
    logits, secs = _prefill(cfg, params, tokens, use_kernel=True)
    launches = {"flash_attention_fwd": fa.launches}
    if launches["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel {launches} times, "
                             f"want {cfg.n_layers}")
    if logits.shape != (PREFILL_BATCH, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    ntok = PREFILL_BATCH * PREFILL_LEN
    log(f"[prefill] {cfg.name} bf16 batch {PREFILL_BATCH} x {PREFILL_LEN} through the kernel: "
        f"{secs:.3f}s ({ntok / secs:.0f} tok/s), launches {launches}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{smi}]")
    return launches


def phase_e2e_fp32(cfg):
    """fp32 prefill with the kernel against the plain path; returns the fp32 weights."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import get_model

    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0),
                                        dtype=torch.float32)
    tokens = torch.from_numpy(make_batch(cfg, PREFILL_LEN, 1)["tokens"]).cuda()
    with_k, t_k = _prefill(cfg, params, tokens, use_kernel=True)
    plain, t_p = _prefill(cfg, params, tokens, use_kernel=False)
    err = rel_l2(with_k, plain)
    same_top = bool((with_k.argmax(-1) == plain.argmax(-1)).all())
    log(f"[e2e] {cfg.name} fp32 batch 1 x {PREFILL_LEN}: kernel vs plain logits rel_l2 "
        f"{err:.3e} (tol {FP32_TOL}), max_abs_err "
        f"{float((with_k - plain).abs().max()):.3e}, max|logit| "
        f"{float(plain.abs().max()):.3e}, same argmax {same_top}; "
        f"{t_k:.3f}s with kernel, {t_p:.3f}s plain")
    if not (err <= FP32_TOL and torch.isfinite(with_k).all()):
        raise AssertionError(f"fp32 prefill with kernel disagrees with plain: rel_l2 {err:.3e}")
    return params


def _decode_prompt(cfg, params, prompts):
    """Logits of the last prompt step, teacher-forcing ``prompts`` through decode_step."""
    from repro_torch.models import get_model

    model = get_model(cfg)
    cache = model.init_cache(cfg, prompts.shape[0], prompts.shape[1],
                             dtype=params["embed"].dtype, device="cuda")
    with torch.no_grad():
        for t in range(prompts.shape[1]):
            logits, cache = model.decode_step(cfg, params, cache, prompts[:, t:t + 1])
    return logits


def phase_serve(cfg, params, params32, smi) -> None:
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.serve import serve

    prompts = torch.from_numpy(make_batch(cfg, SERVE_PROMPT, SERVE_BATCH)["tokens"]).cuda()
    res = serve(cfg, params, prompts, SERVE_DECODE)
    toks = res["tokens"]
    if toks.shape != (SERVE_BATCH, SERVE_DECODE) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"serve returned bad tokens {tuple(toks.shape)}")
    log(f"[serve] {cfg.name} bf16 batch {SERVE_BATCH}: prompt {SERVE_PROMPT} teacher-forced in "
        f"{res['prefill_s']:.3f}s ({SERVE_BATCH * SERVE_PROMPT / res['prefill_s']:.1f} tok/s); "
        f"decoded {SERVE_DECODE} toks/seq in {res['decode_s']:.3f}s "
        f"({SERVE_BATCH * SERVE_DECODE / res['decode_s']:.1f} tok/s) [{smi}]")
    log(f"[serve] sample continuation: {toks[0, :16].tolist()}")

    # The relation of test_decode_matches_forward: the decode loop's logits at
    # the last prompt step against the prefill step's on the same prompt.
    # Held in fp32, where it tests the algorithm.  In bf16 it is measured
    # beside the bf16 noise of the model, the prefill with the kernel against
    # the plain prefill: dense_init's fan-in of L gives attention scores of
    # order 100, which the plain and decode paths round to bf16 (an ulp of
    # 0.5 there), so bf16 paths that round at different places disagree far
    # more than fp32 ones (ROADMAP Queue C).
    dec32 = _decode_prompt(cfg, params32, prompts)
    pre32, _ = _prefill(cfg, params32, prompts, use_kernel=True)
    err32 = rel_l2(dec32, pre32)
    dec = _decode_prompt(cfg, params, prompts).float()
    pre = _prefill(cfg, params, prompts, use_kernel=True)[0].float()
    pre_plain = _prefill(cfg, params, prompts, use_kernel=False)[0].float()
    log(f"[serve] decode vs prefill logits at the last prompt step: fp32 rel_l2 {err32:.3e} "
        f"(tol {FP32_TOL}), argmax agreement "
        f"{float((dec32.argmax(-1) == pre32.argmax(-1)).float().mean()):.2f}; bf16 rel_l2 "
        f"{rel_l2(dec, pre):.3e}, argmax agreement "
        f"{float((dec.argmax(-1) == pre.argmax(-1)).float().mean()):.2f}, beside bf16 "
        f"prefill plain vs kernel rel_l2 {rel_l2(pre_plain, pre):.3e}")
    if not (err32 <= FP32_TOL and torch.isfinite(dec).all()):
        raise AssertionError(f"decode loop disagrees with prefill: fp32 rel_l2 {err32:.3e}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    kernel = phase_kernel_checks()

    cfg = get_config("llama3.2-3b")
    params = get_model(cfg).init_params(cfg, torch.Generator("cuda").manual_seed(0))
    launches = phase_prefill(cfg, params, smi)
    params32 = phase_e2e_fp32(cfg)
    phase_serve(cfg, params, params32, smi)

    line = {"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:37",
        "launches": launches["flash_attention_fwd"],
        "checked": True,
        **kernel,
    }]}
    log(json.dumps(line))
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
