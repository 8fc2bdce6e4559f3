"""recruit_s: seconds a sample in the recruit layer's span, the harness's wrapper
around its entry (trace.SPANS["recruit"]), which ends in a synchronisation."""


def read(trace):
    if not trace.calls or "recruit" not in trace.spans:
        return None
    return trace.span_s("recruit") / len(trace.calls)
