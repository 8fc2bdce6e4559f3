"""align_s: seconds a sample in the align layer's span, the harness's wrapper
around its entry (trace.SPANS["align"]), which ends in a synchronisation."""


def read(trace):
    if not trace.calls or "align" not in trace.spans:
        return None
    return trace.span_s("align") / len(trace.calls)
