"""Entries into the port, one file each, found by the traffic's ``entry``.

Each defines ``run(path, config) -> PackedCounts`` and
``output(result, config) -> bytes``."""
