"""prefill_tokens_per_s: prompt tokens of every prefill call completed in the
window over the window's time, from its start to the last call's completion.
Above the program's capacity the calls queue and this is the rate it serves;
below it, the rate offered."""

UNIT = "tokens/s"


def read(w):
    return w.tokens / w.seconds if w.kind == "prefill" and w.units else None
