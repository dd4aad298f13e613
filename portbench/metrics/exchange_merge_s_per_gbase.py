"""Seconds the port's ``exchange_merge`` spans (``parallel/sharded._exchange``,
one a destination slot: its pieces' peer copies, its K3 merges and K2,
through the sync on its entry count; main thread) took together, per
Gbase counted."""


def read(window):
    s = window.spans.get("exchange_merge")
    return None if s is None else s / (window.bases / 1e9)
