"""align_post_s: seconds a sample in the program's own `align.post` spans:
post-alignment of each locus (the generator resumed with K1's results)
(bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "align.post")
