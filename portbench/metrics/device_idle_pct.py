"""Share of the traced window in which no kernel and no copy ran on the
device: 1 - (union of their intervals) / window."""


def read(window):
    if window.trace is None or window.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - window.trace.busy_s / window.trace.window_s)
