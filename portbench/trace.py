"""Spans around calls into the program, and the reduction of a profiler trace.

``Spans`` wraps named functions of the program's modules for the length of a
``with`` block: each call records CUDA events around itself (its device time)
and a ``record_function`` range of its name (what the host was doing, in the
trace). A name that is missing from its module fails the run.

``reduce`` reads the kernels, copies and the benchmark's host ranges out of a
``torch.profiler`` trace: device time by kernel name, the union of device
activity inside ranges, and the longest idle gaps between device operations
inside a step or call, labelled by the innermost host range open at the time.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import defaultdict

import torch

TOP = 10  # entries of each list in a breakdown


class Spans:
    """CUDA-event spans around calls of ``targets``: name -> (module, attribute)."""

    def __init__(self, targets: dict[str, tuple[str, str]]):
        self.targets = targets
        self.events: dict[str, list] = {name: [] for name in targets}

    def _wrap(self, name, fn):
        events = self.events[name]

        def wrapped(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.profiler.record_function(name):
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            events.append((start, end))
            return out
        return wrapped

    @contextlib.contextmanager
    def active(self):
        with contextlib.ExitStack() as stack:
            for name, (module, attr) in self.targets.items():
                mod = importlib.import_module(module)
                if not hasattr(mod, attr):
                    raise AttributeError(f"span {name}: {module} has no {attr}")
                stack.enter_context(_patched(mod, attr, self._wrap(name, getattr(mod, attr))))
            yield self

    def ms(self) -> dict[str, list[float]]:
        """Device ms of every call, by name (after the caller's sync)."""
        return {name: [a.elapsed_time(b) for a, b in ev] for name, ev in self.events.items()}


@contextlib.contextmanager
def _patched(mod, attr, value):
    old = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield
    finally:
        setattr(mod, attr, old)


def _union(intervals) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(union, starts, a: int, b: int) -> int:
    """ns of [a, b) that the disjoint sorted intervals ``union`` cover."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    total = 0
    while i < len(union) and union[i][0] < b:
        x, y = union[i]
        total += max(0, min(y, b) - max(x, a))
        i += 1
    return total


def reduce(prof, window: str, ranges: str, labels: tuple[str, ...]) -> dict:
    """What the trace of ``prof`` says, in seconds.

    ``window`` names the host range that spans the traced window; ``ranges``
    the ranges of the units of work inside it (a step, a call); ``labels`` the
    host ranges that idle gaps are labelled by, innermost first."""
    names = set(labels) | {window, ranges}
    device, host = [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name not in names:  # the device's copies of the host ranges are no work
                device.append((start, start + e.duration_ns(), name))
        elif name in names:
            host[name].append((start, start + e.duration_ns()))
    if not host.get(window):
        raise RuntimeError(f"the trace has no range {window!r}")
    w0, w1 = host[window][0]
    device = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    if not device:
        raise RuntimeError("the trace holds no device operation inside the window")
    busy = _union((a, b) for a, b, _ in device)
    starts = [a for a, _ in busy]
    by_name: dict[str, list] = defaultdict(lambda: [0, 0])
    for a, b, n in device:
        by_name[n][0] += b - a
        by_name[n][1] += 1
    units = sorted(host.get(ranges, []))
    unit_starts = [a for a, _ in units]
    in_units = sum(b - a for a, b in units)

    def in_a_unit(t):
        i = bisect.bisect_right(unit_starts, t) - 1
        return i >= 0 and t < units[i][1]

    # the longest gaps while a step or call runs (between calls the arrivals idle it)
    longest = sorted(((start - end, (end + start) // 2) for (_, end), (start, _)
                      in zip(busy, busy[1:]) if in_a_unit((end + start) // 2)),
                     reverse=True)[:TOP]
    gaps = [(length / 1e9, next((name for name in labels if any(
        a <= mid < b for a, b in host.get(name, []))), "outside")) for length, mid in longest]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "units": len(units),
        "unit_s": in_units / 1e9,
        "unit_busy_s": sum(_covered(busy, starts, a, b) for a, b in units) / 1e9,
        "kernels": {n: (t / 1e9, c) for n, (t, c) in by_name.items()},
        "device_ops": [[n, t / 1e9] for n, (t, _) in sorted(by_name.items(),
                                                              key=lambda kv: -kv[1][0])][:TOP],
        "idle_gaps": [[label, s] for s, label in gaps],
    }
