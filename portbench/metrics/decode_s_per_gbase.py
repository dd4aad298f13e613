"""Seconds the port's ``decode_codes`` span (``ops/table._pull_table``: the
pulled biased keys to u64 codes on the host; main thread) took, per Gbase
counted."""


def read(window):
    s = window.spans.get("decode_codes")
    return None if s is None else s / (window.bases / 1e9)
