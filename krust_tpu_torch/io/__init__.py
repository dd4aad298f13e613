"""Input abstraction, format detection, sequence readers and the mapped
FASTA file."""

from .format import SequenceFormat
from .input import Input
from .mmapfile import MmapFasta
from .reader import (
    SequenceWithQuality,
    read_records,
    read_records_with_quality,
    stream_input_chunks,
)

__all__ = [
    "Input",
    "MmapFasta",
    "SequenceFormat",
    "SequenceWithQuality",
    "read_records",
    "read_records_with_quality",
    "stream_input_chunks",
]
