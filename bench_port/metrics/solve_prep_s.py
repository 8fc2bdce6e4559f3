"""solve_prep_s: seconds a sample in the program's own `solve.prep` spans: the
solver's inputs: _prepare_solve_inputs of each locus, the combined panel,
the Bayes table and the upload (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "solve.prep")
