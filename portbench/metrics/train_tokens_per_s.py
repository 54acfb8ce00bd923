"""train_tokens_per_s: tokens of every training step completed in the window over
the window's time, from the first step's issue to the last one's completion."""

UNIT = "tokens/s"


def read(w):
    return w.tokens / w.seconds if w.kind == "train" else None
