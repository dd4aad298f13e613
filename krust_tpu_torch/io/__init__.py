"""Input abstraction, format detection, and sequence readers."""

from .format import SequenceFormat
from .input import Input
from .reader import (
    SequenceWithQuality,
    read_records,
    read_records_with_quality,
    stream_input_chunks,
)

__all__ = [
    "Input",
    "SequenceFormat",
    "SequenceWithQuality",
    "read_records",
    "read_records_with_quality",
    "stream_input_chunks",
]
