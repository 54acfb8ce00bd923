"""mfu.prefill: model operations of the window's prefill calls over the calls'
time, from issue to first tokens on the host, as a share of the card's bf16
peak. The head counts the last positions only: the call returns no other."""

from portbench import flops

UNIT = "%"


def read(w):
    if w.kind != "prefill" or not w.units:
        return None
    ops = flops.prefill_flops(w.arch, w.mix["batch"], w.mix["seq"]) * w.units
    return 100.0 * ops / sum(w.service) / flops.PEAK_FLOPS[w.dtype]
