"""Seconds the port's ``feed_pack`` span (``_Feed``: each ``next()`` of the
batch generator: the dense packer and row slicing, or the flat route's
segment slicing; the ``krust-feed`` thread) took, per Gbase counted."""


def read(window):
    s = window.spans.get("feed_pack")
    return None if s is None else s / (window.bases / 1e9)
