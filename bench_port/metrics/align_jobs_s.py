"""align_jobs_s: seconds a sample in the program's own `align.jobs` spans: job
assembly, on the align worker thread: model/locs.py:_prepare_align_jobs
(bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "align.jobs")
