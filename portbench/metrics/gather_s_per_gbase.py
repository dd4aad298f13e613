"""Seconds the port's ``gather_shards`` span (``parallel/sharded._gather``:
the K3 merges of the slots' shards on the first card, through a sync of
that card; main thread) took, per Gbase counted."""


def read(window):
    s = window.spans.get("gather_shards")
    return None if s is None else s / (window.bases / 1e9)
