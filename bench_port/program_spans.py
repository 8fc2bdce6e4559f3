"""The program's own spans and counters, read in process after the window.

The port keeps the spans of its `genotype` calls in memory
(`locityper_tpu_torch/utils/spans.py`): one root span named `genotype` a
call, carrying the call's counters in its `attrs`, and the steps below it,
all on `time.perf_counter()`, the clock the device's operations are placed
on (`trace.DeviceTimeline`).  The readers under `metrics/` that start with a
step's layer read them through this module.  Only calls whose root span lies
inside the traced window count, and seconds are divided by the window's
calls, as the harness's own readers divide theirs.  A program without the
recorder, or a window without such a call, gives None, never 0.
"""
from __future__ import annotations

from fnmatch import fnmatchcase

from .trace import merge


def records():
    """The program's closed spans, oldest first, or None when the program
    keeps none."""
    try:
        from locityper_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.snapshot()


def window_calls(trace):
    """(root spans of the calls inside the window, the other spans of those
    calls), or None."""
    kept = records()
    if not kept or not trace.calls:
        return None
    lo, hi = trace.window
    roots = {s.id: s for s in kept
             if s.name == "genotype" and s.parent is None
             and lo <= s.start and s.end <= hi}
    if not roots:
        return None
    return list(roots.values()), [s for s in kept
                                  if s.call in roots and s.id not in roots]


def seconds(trace, pattern):
    """Seconds a sample in the spans whose name matches `pattern` (fnmatch),
    on any thread."""
    got = window_calls(trace)
    if got is None:
        return None
    return sum(s.end - s.start for s in got[1]
               if fnmatchcase(s.name, pattern)) / len(trace.calls)


def counter(trace, name):
    """The counter summed over the window's calls."""
    got = window_calls(trace)
    if got is None:
        return None
    return sum(root.attrs.get(name, 0) for root in got[0])


def _length(intervals):
    return sum(b - a for a, b in intervals)


def _overlap(a, b):
    """Seconds common to two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_named_pct(trace):
    """Of the device's idle seconds inside the window's calls, the share in
    which the call's own thread was in a step span (`<layer>.<step>`)."""
    got = window_calls(trace)
    if got is None or not trace.device_ops:
        return None
    roots, kept = got
    idle = named = 0.0
    for root in roots:
        edges = [root.start] + [x for a, b in trace.busy
                                if b > root.start and a < root.end
                                for x in (a, b)] + [root.end]
        gaps = [(max(a, root.start), min(b, root.end))
                for a, b in zip(edges[::2], edges[1::2]) if b > a]
        steps = merge((s.start, s.end) for s in kept
                      if s.call == root.id and s.thread == root.thread
                      and "." in s.name)
        idle += _length(gaps)
        named += _overlap(gaps, steps)
    return 100.0 * named / idle if idle > 0 else None
