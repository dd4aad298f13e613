"""Seconds of the benchmark's clock around the output step
(``output.output_packed`` to an in-memory sink), per Gbase counted; only
in cells whose configuration asks for output."""


def read(window):
    return None if window.output_s is None else window.output_s / (window.bases / 1e9)
