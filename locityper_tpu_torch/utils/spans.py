"""Spans and counters of the steps of a `genotype` call, kept in process.

A span is one step of the program on the host: its name (`<layer>.<step>`,
or a layer's name alone), its start and end on `time.perf_counter()`, its
parent span, the id of the call it belongs to, its thread and a few
attributes the host already holds.  A counter is a number the host already
holds, added to the current call.  Nothing here synchronises with the
device or reads from it: a step that waits on the card is its own span,
ending where the program fetches its results anyway.

    with spans.call("genotype") as c:       # one call at a time a process
        with spans.span("recruit"):
            with spans.span("recruit.index", loci=3):
                ...
        spans.count("k1_jobs", n)

Closed spans of a call go into one bounded deque, read in process with
`snapshot()` and written nowhere; a span opened while no call is open
still measures itself (`Span.seconds`) but is not kept.  A span opened on
a worker thread names its parent (`parent=`); otherwise its parent is the
innermost span open on its thread.  While a call runs with `annotate=True`
(`genotype --profile`), every span also opens a
`torch.profiler.record_function` of its name, so that the profiler's trace
shows the steps beside the device's operations.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

#: Closed spans kept: a `genotype` call of three loci opens 42, and one more
#: for each further batch of pairs its FASTQ reader parses.
MAXLEN = 65536


class Span:
    """One step; `end` is None while it is open."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start", "end",
                 "attrs", "_rec", "_prof")

    def __init__(self, rec, name, parent, attrs):
        self.name = name
        self.attrs = attrs
        self.parent = parent
        self._rec = rec
        self.end = None

    @property
    def seconds(self) -> float:
        return (self.end if self.end is not None
                else time.perf_counter()) - self.start

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        self.id = next(rec._ids)
        self.call = rec._call
        self.thread = threading.get_ident()
        self._prof = None
        if rec.annotate:
            from torch.profiler import record_function
            self._prof = record_function(self.name)
            self._prof.__enter__()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        rec = self._rec
        rec._stack().pop()
        if self._prof is not None:
            self._prof.__exit__(*exc)
        if self.call is not None:
            rec.spans.append(self)
        return False


class Recorder:
    """The spans and counters of the calls of one process."""

    def __init__(self, maxlen: int = MAXLEN):
        self.spans: collections.deque = collections.deque(maxlen=maxlen)
        self.annotate = False
        self._call = None           # the open call's Span
        self._counters = None       # its counters, name -> int
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, parent: Span | None = None, **attrs) -> Span:
        """A context manager timing one step (see the module's text)."""
        return Span(self, name, parent, attrs)

    def current(self) -> Span | None:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def count(self, name: str, n: int) -> None:
        """Adds `n` to the open call's counter `name` (dropped when no call
        is open)."""
        with self._lock:
            if self._counters is not None:
                self._counters[name] = self._counters.get(name, 0) + int(n)

    @contextlib.contextmanager
    def call(self, name: str, annotate: bool = False):
        """A context manager around one call: its span is the root of the
        call's spans, and carries the call's counters in `attrs`."""
        outer = (self._call, self._counters, self.annotate)
        root = Span(self, name, None, {})
        with self._lock:
            self._counters = root.attrs
        self.annotate = annotate
        try:
            with root:
                root.parent = None
                root.call = self._call = root.id
                yield root
        finally:
            with self._lock:
                self._call, self._counters, self.annotate = outer

    def snapshot(self) -> list:
        """The closed spans kept, oldest first."""
        return list(self.spans)


_RECORDER = Recorder()
span = _RECORDER.span
current = _RECORDER.current
count = _RECORDER.count
call = _RECORDER.call
snapshot = _RECORDER.snapshot


def summary(root: Span, spans=None) -> str:
    """One line: the call's seconds by layer and by step, and its counters.
    `entry` is the call less its layer spans.  `spans`: the recorder's, by
    default, where the closed call's spans are the last ones kept."""
    kept = itertools.takewhile(
        lambda s: s.call == root.id,
        reversed(_RECORDER.spans if spans is None else spans))
    layers, steps = {}, {}
    for s in kept:
        if s is root:
            continue
        into = steps if "." in s.name else layers
        into[s.name] = into.get(s.name, 0.0) + s.seconds
    layers["entry"] = root.seconds - sum(layers.values())
    parts = []
    for layer in ("entry", "recruit", "align", "solve"):
        mine = [f"{k.partition('.')[2]} {v:.3f}"
                for k, v in steps.items() if k.partition(".")[0] == layer]
        if layer in layers:
            parts.append(f"{layer} {layers[layer]:.3f}"
                         + (f" ({', '.join(mine)})" if mine else ""))
    counters = " ".join(f"{k}={v}" for k, v in sorted(root.attrs.items()))
    return (f"{root.name} call {root.id}: {root.seconds:.3f} s; "
            f"{'; '.join(parts)}; {counters}")
