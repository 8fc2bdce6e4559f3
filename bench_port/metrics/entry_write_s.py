"""entry_write_s: seconds a sample in the program's own `entry.write` spans:
the recruited-read checkpoints, res.json.gz, the success marks and the
checkpoints' removal (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "entry.write")
