"""device_idle_pct.<render|grad>: the share of the traced window in which
no kernel, copy or set ran on the device, in % (100 x (1 - busy / window))."""

SOURCE = "device_trace"
UNIT = "%"


def read(run):
    if run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
