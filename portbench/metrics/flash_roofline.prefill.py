"""flash_roofline.prefill: the bf16 flash-attention kernel's least time a call
(flops.flash_bound_s) over its device time a call in the trace
(flash_fwd_sm90)."""

from portbench import flops

UNIT = "%"


def read(w):
    return flops.flash_roofline(w, "sm90") if w.kind == "prefill" else None
