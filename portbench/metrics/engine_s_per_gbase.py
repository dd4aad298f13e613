"""Seconds of the benchmark's clock around the count entry outside the
port's ``read_sequences`` span (scan, pack, feed, encode, epoch flush,
pull, decode to ``PackedCounts``), per Gbase counted."""


def read(window):
    s = window.spans.get("read_sequences")
    return None if s is None else (window.count_s - s) / (window.bases / 1e9)
