"""device_idle.prefill: the share of the calls' time (issue to first tokens on
the host) in which no kernel, copy or memset runs on the device. The window's
time between calls, which the arrivals leave idle, is not counted."""

UNIT = "%"


def read(w):
    t = w.trace
    if w.kind != "prefill" or not t or not t["unit_s"]:
        return None
    return 100.0 * (1.0 - t["unit_busy_s"] / t["unit_s"])
