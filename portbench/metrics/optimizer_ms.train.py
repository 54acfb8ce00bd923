"""optimizer_ms.train: device ms a training step inside AdamW's apply (clipping,
moments and the update), from CUDA events around each call."""

UNIT = "ms"


def read(w):
    calls = w.spans.get("optimizer")
    return sum(calls) / w.units if w.kind == "train" and calls else None
