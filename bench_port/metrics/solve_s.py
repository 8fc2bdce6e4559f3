"""solve_s: seconds a sample in the solve layer's span, the harness's wrapper
around its entries (trace.SPANS["solve"]), which ends in a synchronisation."""


def read(trace):
    if not trace.calls or "solve" not in trace.spans:
        return None
    return trace.span_s("solve") / len(trace.calls)
