"""Seconds the port's ``exchange_cut`` span (``parallel/sharded._exchange``:
each slot's finished part ordered by owner card, ``_by_owner``, through
the one host sync of the size matrix; main thread) took, per Gbase
counted."""


def read(window):
    s = window.spans.get("exchange_cut")
    return None if s is None else s / (window.bases / 1e9)
