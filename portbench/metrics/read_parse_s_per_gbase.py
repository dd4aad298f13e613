"""Seconds the port's ``read_sequences`` span (``api._read_streams``: the
file read and the C++ parse, eager path) took, per Gbase counted."""


def read(window):
    s = window.spans.get("read_sequences")
    return None if s is None else s / (window.bases / 1e9)
