"""solve_filter_s: seconds a sample in the program's own `solve.filter` spans:
the stage-0 filter on alignment likelihood alone
(bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "solve.filter")
