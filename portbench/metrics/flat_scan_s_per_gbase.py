"""Seconds the port's ``flat_scan`` span (``BatchEngine._feed_streams``: the
C++ or numpy scan of the flat route, one that ends in the dense route
too; main thread) took, per Gbase counted."""


def read(window):
    s = window.spans.get("flat_scan")
    return None if s is None else s / (window.bases / 1e9)
