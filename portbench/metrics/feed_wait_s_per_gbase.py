"""Seconds the port's ``feed_wait`` span (``_Feed.__iter__``: the engine
waiting on the feed's queue for a staged batch; main thread) took, per
Gbase counted."""


def read(window):
    s = window.spans.get("feed_wait")
    return None if s is None else s / (window.bases / 1e9)
