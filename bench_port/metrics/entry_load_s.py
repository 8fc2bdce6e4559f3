"""entry_load_s: seconds a sample in the program's own `entry.load` spans: the
database and background model load, the loci and the recruitment parameters
(commands/genotype.py:_run) (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "entry.load")
