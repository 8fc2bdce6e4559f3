"""entry_s: seconds a sample of a genotype call outside the recruit, align
and solve spans: the command line's start, the database load, the writing
of res.json.gz and the rest of commands/genotype.run."""


def read(trace):
    if not trace.calls:
        return None
    whole = sum(b - a for a, b in trace.calls)
    inner = sum(trace.span_s(k) for k in ("recruit", "align", "solve"))
    return (whole - inner) / len(trace.calls)
