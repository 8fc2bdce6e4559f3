"""recruit_read_s: seconds a sample in the program's own `recruit.read`
spans: the FASTQ reader's thread inflating, parsing and packing each batch
of pairs, which the main thread's `recruit.parse` waits on
(bench_port/program_spans.py).  None where the window's calls have no such
span."""
from bench_port import program_spans


def read(trace):
    got = program_spans.window_calls(trace)
    if got is None or not any(s.name == "recruit.read" for s in got[1]):
        return None
    return program_spans.seconds(trace, "recruit.read")
