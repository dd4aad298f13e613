"""Seconds the port's ``histogram`` span (``histogram.compute_histogram_array``:
``np.unique`` over the counts and the dict; main thread) took, per Gbase
counted."""


def read(window):
    s = window.spans.get("histogram")
    return None if s is None else s / (window.bases / 1e9)
