"""Seconds the port's ``feed_stage`` span (``_Feed``: each batch's padded
host copy, pinning and non-blocking copy enqueue; the ``krust-feed`` thread)
took, per Gbase counted."""


def read(window):
    s = window.spans.get("feed_stage")
    return None if s is None else s / (window.bases / 1e9)
