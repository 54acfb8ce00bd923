"""device_idle.train: the share of the traced window in which no kernel, copy or
memset runs on the device."""

UNIT = "%"


def read(w):
    t = w.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if w.kind == "train" and t else None
