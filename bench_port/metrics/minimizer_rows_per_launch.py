"""minimizer_rows_per_launch: the program's counters `k3_rows` (the rows
handed to the minimizer front end's compacting entry, two a pair) over
`k3_launches` (its CUDA launches, from `_kernels.LAUNCHES`), summed over the
window's calls (bench_port/program_spans.py).  None without a launch, or
from a program that does not count `k3_rows`."""
from bench_port import program_spans


def read(trace):
    rows = program_spans.counter(trace, "k3_rows")
    launches = program_spans.counter(trace, "k3_launches")
    if not launches or not rows:
        return None
    return rows / launches
