"""recruit_parse_s: seconds a sample in the program's own `recruit.parse`
spans: waiting on the FASTQ parser's thread for the next batch of pairs (and
probing the read length) (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "recruit.parse")
