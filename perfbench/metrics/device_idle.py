"""``device_idle``: the share of the traced sub-window in which no kernel,
copy or fill ran on the card, from the profiler's device records (layer:
the device).  Where CUPTI dropped K3 or K4 records it is an upper bound."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
