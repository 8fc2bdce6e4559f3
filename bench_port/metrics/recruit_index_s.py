"""recruit_index_s: seconds a sample in the program's own `recruit.index`
spans: the recruitment index: TargetIndex built from every locus and moved
to the card as DeviceIndex (bench_port/program_spans.py)."""
from bench_port import program_spans


def read(trace):
    return program_spans.seconds(trace, "recruit.index")
