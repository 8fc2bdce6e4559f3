"""The traced run's instruments: spans around the calls into each layer,
the kernels' launch shapes, and the device's timeline from `torch.profiler`
(CUDA activity only), all read after the window by the per-layer readers
under `metrics/`.

Every span wrapper ends in `torch.cuda.synchronize()`, so a span holds its
layer's device work; the kernel recorders do not synchronise, so that the
pipelines inside a layer keep their overlap.  What the wrappers add on the
host is the traced run's overhead (`PERF.md`).
"""
from __future__ import annotations

import contextlib
import importlib
import json
import time
from dataclasses import dataclass, field

import torch

from . import roofline

#: Layer span name -> (module, attribute) of the call into it.
SPANS = {
    "recruit": ("locityper_tpu_torch.commands.genotype", "recruit_reads_fast"),
    "align": ("locityper_tpu_torch.model.locs", "build_all_alignments_panel"),
    "solve": ("locityper_tpu_torch.pipeline", "genotype_panel"),
}
#: Kernel -> (module, attribute of its wrapper, a word of its device name).
KERNELS = {
    "align_banded": ("locityper_tpu_torch.ops.align", "align_banded",
                     "align_banded_kernel"),
    "anneal_chains": ("locityper_tpu_torch.ops.solver_chains",
                      "anneal_chains", "anneal_chains_kernel"),
    "minimizer_front": ("locityper_tpu_torch.ops.recruit", "minimizer_front",
                        "minimizer_front"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@dataclass
class Trace:
    """What a traced window left: host spans (perf_counter seconds), each
    call's (t0, t1), kernel launches with their counted work, and device
    operations (name, start, seconds) on the same clock."""
    window: tuple = (0.0, 0.0)
    calls: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)
    launches: dict = field(default_factory=dict)
    device_ops: list = field(default_factory=list)
    busy: list = field(default_factory=list)    # merged device intervals

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy)

    def span_s(self, name):
        return sum(b - a for a, b in self.spans.get(name, []))

    def kernel_s(self, kernel):
        word = KERNELS[kernel][2]
        return sum(d for n, _, d in self.device_ops if word in n)

    def bound_s(self, kernel):
        """Least seconds of the kernel's launches, summed, or None."""
        total = 0.0
        for rec in self.launches.get(kernel, []):
            ops, nbytes = rec() if callable(rec) else rec
            total += roofline.bound_s(ops, nbytes)[0]
        return total if self.launches.get(kernel) else None

    def roofline_pct(self, kernel):
        bound, spent = self.bound_s(kernel), self.kernel_s(kernel)
        if not bound or spent <= 0:
            return None
        return 100.0 * bound / spent


def merge(intervals):
    """Union of (start, end) intervals, sorted and disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


@contextlib.contextmanager
def patch(where, attr, make):
    """Replaces `attr` of `where` ("module" or "module:Class") by
    `make(original)` while in use, and puts the original back."""
    module, _, cls = where.partition(":")
    owner = importlib.import_module(module)
    if cls:
        owner = getattr(owner, cls)
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def span_wrapper(trace: Trace, name):
    def make(orig):
        def span(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                trace.spans.setdefault(name, []).append(
                    (t0, time.perf_counter()))
        return span
    return make


def recorders(trace: Trace):
    """Kernel -> wrapper maker that records each launch's counted work,
    read lazily so that the window gains no synchronisation."""
    def rec_align(orig):
        def align_banded(reads, rlens, hap_wins, score_vec, band=48,
                         max_del_run=32):
            out = orig(reads, rlens, hap_wins, score_vec, band, max_del_run)
            N, L = reads.shape
            if N:
                rows = torch.clamp(rlens, max=L).sum()
                trace.launches.setdefault("align_banded", []).append(
                    lambda: roofline.align_banded(N, L, band, int(rows)))
            return out
        return align_banded

    def rec_anneal(orig):
        def anneal_chains(*a, **kw):
            out = orig(*a, **kw)
            C, R, _ = a[1].shape
            if C:
                moves = out[2].sum()
                in_bytes = _nbytes(*a)
                W = a[6].shape[1]
                trace.launches.setdefault("anneal_chains", []).append(
                    lambda: roofline.anneal_chains(in_bytes, C, R, W,
                                                   int(moves)))
            return out
        return anneal_chains

    def rec_front(orig):
        def minimizer_front(reads, k, w, S=None):
            out = orig(reads, k, w, S)
            B, L = reads.shape
            if B:
                trace.launches.setdefault("minimizer_front", []).append(
                    roofline.minimizer_front(B, L, k, w, S))
            return out
        return minimizer_front

    return {"align_banded": rec_align, "anneal_chains": rec_anneal,
            "minimizer_front": rec_front}


@contextlib.contextmanager
def tracer(trace: Trace):
    """The span wrappers and the launch recorders, installed while in
    use."""
    with contextlib.ExitStack() as stack:
        for name, (module, attr) in SPANS.items():
            stack.enter_context(patch(module, attr, span_wrapper(trace, name)))
        for kernel, make in recorders(trace).items():
            module, attr, _ = KERNELS[kernel]
            stack.enter_context(patch(module, attr, make))
        yield trace


class DeviceTimeline:
    """torch.profiler over the window, CUDA activity only; a marker kernel
    launched right after a synchronisation at the window's start ties the
    device's clock to the host's."""

    def __init__(self, trace: Trace, trace_path):
        self.trace = trace
        self.path = trace_path
        self.marker_host = self.end_host = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.end_host = time.perf_counter()
        self.prof.stop()
        self.prof.export_chrome_trace(str(self.path))

    def read(self):
        """Fills the trace's device operations and busy intervals."""
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "ts" in e and "dur" in e]
        marker = [e for e in dev if MARKER in e.get("name", "")]
        # Device microseconds -> host seconds.
        offset = (self.marker_host - marker[0]["ts"] / 1e6 if marker
                  else self.trace.window[0]
                  - min((e["ts"] for e in dev), default=0.0) / 1e6)
        self.trace.device_ops = [
            (e["name"], e["ts"] / 1e6 + offset, e["dur"] / 1e6)
            for e in dev if MARKER not in e.get("name", "")]
        self.trace.busy = merge((s, s + d)
                                for _, s, d in self.trace.device_ops)
        return bool(marker)


def breakdown(trace: Trace, top=10):
    """The device operations that took most time, and the longest idle
    gaps named by the layer span the host was in (`entry` inside a call but
    outside the layer spans, `between` outside every call)."""
    by_name = {}
    for name, _, d in trace.device_ops:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [trace.window[0]] + [x for ab in trace.busy for x in ab] \
        + [trace.window[1]]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def where(t):
        for name, spans in trace.spans.items():
            if any(a <= t < b for a, b in spans):
                return name
        return "entry" if any(a <= t < b for a, b in trace.calls) \
            else "between"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[where((a + b) / 2), b - a] for a, b in longest]}
