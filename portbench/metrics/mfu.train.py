"""mfu.train: model operations of the window's training steps over the window's
time, as a share of the card's TF32 peak (the fastest route for float32
inputs). Recomputation's second forward pass is not counted."""

from portbench import flops

UNIT = "%"


def read(w):
    if w.kind != "train" or not w.units:
        return None
    ops = flops.train_step_flops(w.arch, w.mix["batch"], w.mix["seq"]) * w.units
    return 100.0 * ops / w.seconds / flops.PEAK_FLOPS["tf32"]
