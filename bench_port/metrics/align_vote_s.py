"""align_vote_s: seconds a sample in the program's own `align.vote` spans:
candidate voting, on the align worker thread: the generator of model/locs.py
up to job assembly (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "align.vote")
