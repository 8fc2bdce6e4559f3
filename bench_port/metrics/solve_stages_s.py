"""solve_stages_s: seconds a sample in the program's own `solve.stage*` spans:
the solver's stages (solve.stage<N>): chunk launches, fetches, digests and
culling (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "solve.stage*")
