"""krust_tpu_torch — the k-mer counting engine on PyTorch and CUDA.

The port of ``krust_tpu`` (JAX on a TPU) to an NVIDIA H100. It rebuilds the
surface of the reference Rust tool ``kmerust`` (suchapalaver/krust):
canonical k-mer counting (k = 1-32, 2-bit packed) over FASTA/FASTQ
(plain/gzip, file/stdin) with N-base skipping, soft-mask normalization and
Phred quality filtering; FASTA/TSV/JSON/histogram output with min-count
filtering; a byte-compatible binary ``.kmix`` index plus query; library,
builder, streaming, progress, memory-mapped and async APIs; and a CLI with
the same UX.

Architecture (GPU):
  host reader/packer  ->  packed 2-bit stream slices + sparse invalid positions
                          (dirty streams: haloed 2-bit rows + invalid bitmask)
  codec kernel        ->  one biased canonical key per window (sentinel if bad)
  epoch sort + RLE    ->  compacted distinct (key, count) parts on the device
  merge kernel + RLE  ->  one part; copied to the host as u64 (code, count)

This package imports torch and never jax or krust_tpu.
"""

__version__ = "0.7.0"

from .api import (
    count_kmers,
    count_kmers_files,
    count_kmers_from_input,
    count_kmers_from_input_packed,
    count_kmers_with_format,
    count_kmers_with_quality,
    count_kmers_with_progress,
    count_kmers_streaming,
    count_kmers_streaming_packed,
    count_kmers_packed,
    count_kmers_sequential,
    count_kmers_from_reader,
    count_kmers_from_reader_packed,
    count_kmers_stdin,
    count_kmers_stdin_packed,
    count_kmers_stdin_with_format,
    count_kmers_from_sequences,
    count_kmers_from_sequences_packed,
    count_kmers_mmap,
    count_kmers_sniffed,
    count_with_input,
    run,
    run_with_options,
    run_with_input,
    run_with_input_format,
    run_with_quality,
)
from .async_api import AsyncKmerCounter, count_kmers_async, count_kmers_packed_async
from .builder import KmerCounter
from .errors import (
    BuilderError,
    FormatError,
    InvalidBaseError,
    InvalidIndexError,
    IndexReadError,
    IndexWriteError,
    KmerLengthError,
    KrustError,
    ReadError,
)
from .histogram import (
    HistogramStats,
    compute_histogram,
    compute_histogram_packed,
    histogram_stats,
)
from .index import KmerIndex, load_index, save_index
from .io.format import SequenceFormat
from .io.input import Input
from .io.mmapfile import MmapFasta
from .kmer import (
    Kmer,
    KmerBase,
    KmerLength,
    canonical_packed,
    canonical_string,
    pack,
    unpack_to_bytes,
    unpack_to_string,
)
from .models.engines import PackedCounts
from .output import OutputFormat, format_packed_counts, output_counts, output_packed
from .utils.progress import Progress, ProgressTracker

__all__ = [
    "__version__",
    # counting
    "count_kmers",
    "count_kmers_with_format",
    "count_kmers_with_quality",
    "count_kmers_with_progress",
    "count_kmers_files",
    "count_kmers_from_input",
    "count_kmers_from_input_packed",
    "count_kmers_streaming",
    "count_kmers_streaming_packed",
    "count_kmers_packed",
    "count_kmers_sequential",
    "count_kmers_from_reader",
    "count_kmers_from_reader_packed",
    "count_kmers_stdin",
    "count_kmers_stdin_packed",
    "count_kmers_stdin_with_format",
    "count_kmers_sniffed",
    "count_kmers_from_sequences",
    "count_kmers_from_sequences_packed",
    "count_kmers_mmap",
    "count_with_input",
    "run",
    "run_with_options",
    "run_with_input",
    "run_with_input_format",
    "run_with_quality",
    # async
    "AsyncKmerCounter",
    "count_kmers_async",
    "count_kmers_packed_async",
    # builder
    "KmerCounter",
    # kmer core
    "Kmer",
    "KmerBase",
    "KmerLength",
    "pack",
    "unpack_to_bytes",
    "unpack_to_string",
    "canonical_packed",
    "canonical_string",
    # io
    "Input",
    "MmapFasta",
    "SequenceFormat",
    # output / histogram
    "OutputFormat",
    "output_counts",
    "output_packed",
    "format_packed_counts",
    "compute_histogram",
    "compute_histogram_packed",
    "histogram_stats",
    "HistogramStats",
    # index
    "KmerIndex",
    "save_index",
    "load_index",
    # progress
    "Progress",
    "ProgressTracker",
    "PackedCounts",
    # errors
    "KrustError",
    "KmerLengthError",
    "InvalidBaseError",
    "BuilderError",
    "FormatError",
    "ReadError",
    "IndexReadError",
    "IndexWriteError",
    "InvalidIndexError",
]
