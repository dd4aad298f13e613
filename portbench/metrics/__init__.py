"""Per-layer metric readers, one file each, found by the metric's name.

Each defines ``read(window) -> float | None`` over a
:class:`portbench.run.Window`; it returns None where it finds nothing to
read, and the harness then leaves the metric out of the line."""
