"""idle_named_pct: of the device's idle seconds inside the window's
`genotype` calls (gaps of the profiler's busy intervals), the share in which
the call's own thread was in one of the program's step spans, so that the
idle gap is named by the host step that held the card
(bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.idle_named_pct(trace)
