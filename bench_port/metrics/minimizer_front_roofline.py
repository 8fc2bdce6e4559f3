"""minimizer_front_roofline: the kernel's share of its roofline over the traced
window: the sum over its launches of the least time the card could take
(roofline.minimizer_front's operations and bytes against the published peaks) over
the sum of its device time in the profiler's trace."""


def read(trace):
    return trace.roofline_pct("minimizer_front")
