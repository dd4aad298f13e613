"""Seconds the port's ``part_merge`` spans (``ops/table.EpochTable.
_merge_compacted``, one a pair of compacted epoch parts: K3's merge, K2's
weighted re-compaction and the sync on the merged entry count; main
thread) took together, per Gbase counted."""


def read(window):
    s = window.spans.get("part_merge")
    return None if s is None else s / (window.bases / 1e9)
