"""Seconds the port's ``epoch_resolve`` spans (``ops/table.EpochTable.
_resolve_epoch``: the sync on an epoch flush's distinct count, which waits
for the flush's sort and K2, the one-shot retune of the epoch size and the
copy of the compacted part; main thread) took together, per Gbase
counted."""


def read(window):
    s = window.spans.get("epoch_resolve")
    return None if s is None else s / (window.bases / 1e9)
