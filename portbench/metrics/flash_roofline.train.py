"""flash_roofline.train: the fp32 flash-attention kernel's least time a call
(flops.flash_bound_s) over its device time a call in the trace (split_kv and
flash_fwd_tf32 together, one launch as the program counts it)."""

from portbench import flops

UNIT = "%"


def read(w):
    return flops.flash_roofline(w, "tf32") if w.kind == "train" else None
