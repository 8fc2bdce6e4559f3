"""align_wait_s: seconds a sample in the program's own `align.wait` spans:
waiting on the align worker's voting and on K1's results
(collect_align_batches) (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "align.wait")
