"""device_idle_pct: the share of the traced window in which no operation
(kernel, copy or fill) runs on the card: the window less the union of the
device's operation intervals from the profiler's trace."""


def read(trace):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
