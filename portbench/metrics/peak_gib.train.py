"""peak_gib.train: the allocator's peak over the window
(torch.cuda.max_memory_allocated after a reset at its start)."""

UNIT = "GiB"


def read(w):
    return w.peak_bytes / 2**30 if w.kind == "train" and w.peak_bytes else None
