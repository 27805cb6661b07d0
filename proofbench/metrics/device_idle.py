"""The card's idle share of the traced window, in percent: one minus the
union of the intervals in which any operation ran on the device (the
profiler's trace), over the window's length."""

NAME = "device_idle"


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
