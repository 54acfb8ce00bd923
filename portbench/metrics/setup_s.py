"""setup_s: seconds from the process's start to the window's start: imports,
kernel builds or loads, weights, the first steps or warm-up calls."""

UNIT = "s"


def read(w):
    return w.setup_s
