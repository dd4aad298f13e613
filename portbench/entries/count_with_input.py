"""``kmix-torch count <k> <file> [-Q q] [-f <format>]`` as its two calls
(``cli.py``): ``api.count_with_input``, then ``output.output_packed`` to
an in-memory sink."""

from __future__ import annotations

import io


def run(path: str, config: dict):
    from krust_tpu_torch import api
    from krust_tpu_torch.io.format import SequenceFormat
    from krust_tpu_torch.io.input import Input

    return api.count_with_input(Input.from_path(path), config["k"], SequenceFormat.AUTO,
                                config["min_quality"])


def output(result, config: dict) -> bytes:
    from krust_tpu_torch.output import OutputFormat, output_packed

    sink = io.BytesIO()
    output_packed(result, OutputFormat(config["output"]), 1, out=sink)
    return sink.getvalue()
