"""The yardstick's arithmetic: peaks of the card, model operations of a step and
a call, and the flash kernel's operations and bytes.

Peaks are NVIDIA's data sheet for the H100 SXM, dense, at 700 W. Operations
count multiply-adds as two; a causal attention counts the (q, k) pairs that
the mask keeps, q·k and p·v each.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}


def pairs(s: int, causal: bool = True) -> int:
    """(q, k) pairs of one row and head: those the causal mask keeps, or all."""
    return s * (s + 1) // 2 if causal else s * s


def linear_per_token(cfg: dict) -> int:
    """Multiply-adds of a token through one layer's products (attention's
    projections, the router and the k experts it takes, or the dense MLP)."""
    d, hd, h, kv, f = (cfg["d_model"], cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"],
                       cfg["d_ff"])
    attn = d * h * hd + 2 * d * kv * hd + h * hd * d
    if cfg.get("n_experts"):
        return attn + d * cfg["n_experts"] + cfg["top_k"] * 3 * d * f
    return attn + 3 * d * f


def attention_flops(cfg: dict, b: int, s: int, causal: bool = True) -> int:
    """q·k and p·v of every layer over b rows of s tokens."""
    return 4 * b * cfg["n_heads"] * cfg["head_dim"] * pairs(s, causal) * cfg["n_layers"]


def forward_flops(cfg: dict, b: int, s: int, unembed_rows: int, causal: bool = True) -> int:
    """A forward pass over b rows of s tokens, the head over ``unembed_rows``
    positions."""
    return (2 * cfg["n_layers"] * linear_per_token(cfg) * b * s
            + attention_flops(cfg, b, s, causal)
            + 2 * cfg["d_model"] * cfg["vocab"] * unembed_rows)


def train_step_flops(cfg: dict, b: int, s: int) -> int:
    """Model operations of a training step: the forward pass with the head over
    every position, and a backward pass of twice its operations. The forward
    pass that recomputation runs again is not counted."""
    return 3 * forward_flops(cfg, b, s, unembed_rows=b * s)


def prefill_flops(cfg: dict, b: int, s: int) -> int:
    """Model operations of a prefill call: the head over the last positions,
    the only ones the call returns."""
    return forward_flops(cfg, b, s, unembed_rows=b)


def flash_flops(b: int, s: int, h: int, hd: int) -> int:
    """One causal flash-attention forward: q·k and p·v over the kept pairs."""
    return 4 * b * h * hd * pairs(s)


def flash_bytes(b: int, s: int, h: int, kv: int, hd: int, dtype: str) -> int:
    """q, k, v read once and o written once."""
    return (2 * b * s * h * hd + 2 * b * s * kv * hd) * BYTES[dtype]


def flash_bound_s(b: int, s: int, h: int, kv: int, hd: int, dtype: str) -> float:
    """The least time of one call: its operations at the route's peak (TF32 for
    float32 inputs) or its bytes at the memory's, whichever is longer."""
    peak = PEAK_FLOPS["tf32" if dtype == "float32" else dtype]
    return max(flash_flops(b, s, h, hd) / peak,
               flash_bytes(b, s, h, kv, hd, dtype) / PEAK_BYTES_PER_S)


FLASH_KERNELS = ("flash_fwd", "split_kv")  # the kernels' names in a trace, as compiled


def flash_roofline(w, variant: str) -> float | None:
    """The flash kernel's bound over its device time a call, in %, from a traced
    window ``w``; None where the trace holds no launch of ``variant``."""
    launches = w.launches.get(variant, 0)
    if not w.trace or not launches:
        return None
    seconds = sum(t for name, (t, _) in w.trace["kernels"].items()
                  if any(k in name for k in FLASH_KERNELS))
    if not seconds:
        return None
    a = w.arch
    bound = flash_bound_s(w.mix["batch"], w.mix["seq"], a["n_heads"], a["n_kv_heads"],
                          a["head_dim"], w.dtype)
    return 100.0 * bound * launches / seconds
