"""anneal_chains_per_launch: the program's counters `k2_chains` (the chains
handed to the annealer) over `k2_launches` (its CUDA launches, from
`_kernels.LAUNCHES`), summed over the window's calls
(bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    chains = program_spans.counter(trace, "k2_chains")
    launches = program_spans.counter(trace, "k2_launches")
    if not launches:
        return None
    return chains / launches
