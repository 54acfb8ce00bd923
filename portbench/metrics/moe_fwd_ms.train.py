"""moe_fwd_ms.train: device ms a training step inside the expert layer's
forward (moe_apply), the recomputation's second forward included, from CUDA
events around each call."""

UNIT = "ms"


def read(w):
    calls = w.spans.get("moe")
    return sum(calls) / w.units if w.kind == "train" and calls else None
