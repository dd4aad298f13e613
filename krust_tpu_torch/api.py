"""Public counting APIs (reference: src/run.rs:66-426, src/streaming.rs:95-509).

Every reference entry point has an equivalent here with the same semantics;
string-keyed functions return ``dict[str, int]`` of canonical k-mer ->
count, packed variants return ``dict[int, int]`` keyed by the 2-bit packed
canonical code.
"""

from __future__ import annotations

import os
import sys
from typing import BinaryIO, Callable, Iterable, TextIO

from .io.format import SequenceFormat
from .io.input import Input
from .io.reader import (
    parse_records,
    parse_to_streams,
    read_input_bytes,
    read_streams,
    streams_from_sequences,
)
from .kmer import KmerLength
from .models.engines import (
    PackedCounts,
    SequentialEngine,
    count_streams,
)
from .output import OutputFormat, output_counts, output_packed
from .utils.config import EngineConfig
from .utils.progress import Progress, ProgressTracker
from .utils.tracing import span

ProgressCallback = Callable[[Progress], None]

#: default record-aligned chunk size for stdin/reader ingest (bounded RSS
#: for arbitrarily large pipes; files default to eager, which is faster on
#: inputs that fit in RAM — set EngineConfig.ingest_chunk_bytes to bound those)
DEFAULT_STDIN_CHUNK_BYTES = 256 << 20


def _read_streams(path, k: int, fmt: SequenceFormat, min_quality: int | None = None):
    """Shared preamble: validate k, resolve format, read + parse. The span
    says on how many threads the parse ran, whether it read a mapping of
    the file, and whether it made a quality stream (only a count with
    ``min_quality`` reads one)."""
    kk = KmerLength(k).get()
    resolved = fmt.resolve(path)
    with span("read_sequences", path=str(path), format=str(resolved)) as fields:
        streams, fields["threads"], fields["mapped"] = read_streams(
            path, resolved, quality=min_quality is not None
        )
        fields["quality"] = streams.qual is not None
    return kk, streams


def _count_path(
    path: str | os.PathLike | None,
    k: int,
    fmt: SequenceFormat = SequenceFormat.AUTO,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
    progress: ProgressCallback | None = None,
) -> PackedCounts:
    """Shared pipeline: read -> parse -> pack -> device count.

    With ``config.ingest_chunk_bytes`` set, the input streams through
    record-aligned chunks instead of one eager whole-file parse — bounded
    host memory for genome-scale inputs (exact; reference's streaming
    analogs: src/streaming.rs:513-616).
    """
    cfg = config or EngineConfig()
    tracker = ProgressTracker() if progress is not None else None
    chunk_bytes = cfg.ingest_chunk_bytes
    if chunk_bytes is None and path is None:
        # stdin defaults to bounded-memory chunked ingest: a pipe can be
        # arbitrarily large and has no size to pre-check (reference's
        # record-at-a-time stdin path: src/streaming.rs:513-616)
        chunk_bytes = DEFAULT_STDIN_CHUNK_BYTES
    if chunk_bytes:
        from .io.reader import stream_input_chunks
        from .models.engines import count_chunked_streams

        kk = KmerLength(k).get()
        with span("read_sequences", path=str(path), chunked=True):
            chunks = stream_input_chunks(path, fmt, chunk_bytes)
            return count_chunked_streams(
                chunks, kk, min_quality, cfg, progress, tracker
            )
    kk, streams = _read_streams(path, k, fmt, min_quality)
    return count_streams(streams, kk, min_quality, cfg, progress, tracker)


# --- string-keyed API (reference: src/run.rs) --------------------------------------


def count_kmers(path: str | os.PathLike, k: int) -> dict[str, int]:
    """Count canonical k-mers in a FASTA/FASTQ file
    (reference: src/run.rs:221-344)."""
    return _count_path(path, k).to_string_dict()


def count_kmers_with_format(
    path: str | os.PathLike, k: int, fmt: SequenceFormat
) -> dict[str, int]:
    """Count with an explicit input format (reference: src/run.rs:262-300)."""
    return _count_path(path, k, fmt).to_string_dict()


def count_kmers_with_quality(
    path: str | os.PathLike,
    k: int,
    fmt: SequenceFormat = SequenceFormat.AUTO,
    min_quality: int | None = None,
) -> dict[str, int]:
    """Count with Phred quality filtering for FASTQ
    (reference: src/run.rs:304-344). Quality is ignored for FASTA."""
    return _count_path(path, k, fmt, min_quality).to_string_dict()


def count_kmers_with_progress(
    path: str | os.PathLike,
    k: int,
    callback: ProgressCallback,
    exact_cadence: bool = False,
) -> dict[str, int]:
    """Count while reporting progress (reference: src/run.rs:382-426).

    Cadence: the device engine's unit of work is a window batch, so by
    default the callback fires once per batch with record/base totals
    apportioned by window fraction and trued up exactly at the end
    (monotonic, exact totals — see models/engines._ProgressPacer). The
    reference fires after every sequence from its worker threads
    (reference: src/run.rs:586-654); pass ``exact_cadence=True`` for that
    behavior — one callback per record with exact running totals, on the
    record-at-a-time engine (slower; meant for progress bars over few
    huge records where per-batch estimates are too coarse).
    """
    if exact_cadence:
        kk = KmerLength(k).get()
        resolved = SequenceFormat.AUTO.resolve(path)
        with span("read_sequences", path=str(path), format=str(resolved)):
            data = read_input_bytes(path)
            records = parse_records(data, resolved)
        engine = SequentialEngine()
        return engine.count_records(
            records, kk, progress=callback, tracker=ProgressTracker()
        ).to_string_dict()
    return _count_path(path, k, progress=callback).to_string_dict()


def count_kmers_mmap(
    path: str | os.PathLike, k: int, config: EngineConfig | None = None
) -> dict[str, int]:
    """Count from a memory-mapped FASTA file (reference: src/run.rs:691-756).

    The file bytes are mapped read-only through :class:`~krust_tpu_torch.io.
    mmapfile.MmapFasta` instead of read eagerly; parsing consumes the map
    directly (page-cache-backed, no heap copy of the file).
    """
    from .io.mmapfile import MmapFasta

    resolved = SequenceFormat.AUTO.resolve(path)
    with MmapFasta.open(path) as mapped:
        if mapped.is_empty():
            return {}
        streams = parse_to_streams(mapped.as_bytes(), resolved)
    return count_streams(streams, KmerLength(k).get(), config=config).to_string_dict()


def count_kmers_files(
    paths: Iterable[str | os.PathLike],
    k: int,
    fmt: SequenceFormat = SequenceFormat.AUTO,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
) -> dict[str, int]:
    """Count canonical k-mers across SEVERAL files into one table.

    New capability beyond the reference's one-input-per-run CLI (jellyfish
    accepts multiple inputs; `count_kmers_async`'s gather counts files
    separately): every file streams through the same engine table in
    record-aligned bounded-memory chunks, so the result is exactly the
    per-file counts summed. Format resolves per file (mixed FASTA/FASTQ/
    gzip inputs are fine); ``min_quality`` applies to FASTQ files only.
    """
    from .io.reader import stream_input_chunks
    from .models.engines import count_chunked_streams

    kk = KmerLength(k).get()
    cfg = _streaming_config(config)

    # an explicit ingest_chunk_bytes=0 ("eager") still streams per file
    # here — multi-file counting is chunk-fed by construction
    chunk_bytes = cfg.ingest_chunk_bytes or DEFAULT_STREAMING_CHUNK_BYTES

    def chained():
        for p in paths:
            with span("read_sequences", path=str(p), chunked=True):
                yield from stream_input_chunks(p, fmt, chunk_bytes)

    return count_chunked_streams(
        chained(), kk, min_quality, cfg
    ).to_string_dict()


def count_kmers_sniffed(path: str | os.PathLike, k: int) -> dict[str, int]:
    """Count with content-based format detection — the runtime equivalent of
    the reference's needletail reader backend (reference: src/reader.rs
    needletail cfg variants): the first byte after any leading line terminators picks
    FASTA ('>') or FASTQ ('@') regardless of the file extension.
    """
    kk = KmerLength(k).get()
    data = read_input_bytes(path)
    resolved = SequenceFormat.AUTO.resolve_with_content(path, data)
    streams = parse_to_streams(data, resolved)
    return count_streams(streams, kk).to_string_dict()


def count_kmers_sharded(
    path: str | os.PathLike,
    k: int,
    fmt: SequenceFormat = SequenceFormat.AUTO,
    min_quality: int | None = None,
    mesh=None,
    config: EngineConfig | None = None,
) -> dict[str, int]:
    """Count across the GPUs of a mesh: every local GPU by default.

    The distributed entry point (new capability — the reference is
    single-process; SURVEY.md §5). With no process group, one call counts
    the file over every GPU this process sees (or ``mesh``'s devices, or
    ``config.device`` alone when it names one): each GPU counts its share
    of the batches in its own table, the tables exchange their entries by a
    hash of the key once a table lifetime, and the result is the whole exact
    table. Across hosts, start one process per host or one per GPU
    (``torchrun --nproc-per-node``) and call
    :func:`krust_tpu_torch.parallel.mesh.init_distributed` first: every
    rank drives its share of its host's GPUs, calls this with its own file
    and gets the exact counts of its GPUs' hash ranges, disjoint from the
    other ranks'.
    """
    counts = count_kmers_sharded_result(path, k, fmt, min_quality, mesh, config)
    return counts.to_string_dict()


def count_kmers_sharded_result(
    path: str | os.PathLike,
    k: int,
    fmt: SequenceFormat = SequenceFormat.AUTO,
    min_quality: int | None = None,
    mesh=None,
    config: EngineConfig | None = None,
) -> PackedCounts:
    """Packed-result variant of :func:`count_kmers_sharded`."""
    from .parallel.sharded import count_sharded

    kk, streams = _read_streams(path, k, fmt, min_quality)
    return count_sharded(streams, kk, min_quality, mesh, config)


# --- packed + streaming API (reference: src/streaming.rs) ---------------------------


#: default record-aligned chunk size for the *_streaming functions: inputs
#: stream through the engine in chunks of this size, so host RSS stays
#: bounded no matter how large the file (a file smaller than one chunk
#: parses in a single chunk — effectively the eager path)
DEFAULT_STREAMING_CHUNK_BYTES = 256 << 20


def _streaming_config(config: EngineConfig | None = None) -> EngineConfig:
    """Config for the streaming entry points: bounded-memory ingest ON.

    Unlike the reference — whose "streaming" engine reads the entire file
    before the parallel pass (src/streaming.rs:857-899) — the functions
    named streaming here default to true record-aligned chunked ingest;
    results are exactly equal either way. An explicit
    ``ingest_chunk_bytes`` is respected: a positive value sets the chunk
    size, 0 forces the eager whole-file parse (None — the dataclass
    default — means "unset" and takes the chunked default here).
    """
    cfg = config or EngineConfig()
    if cfg.ingest_chunk_bytes is None:
        from dataclasses import replace

        cfg = replace(cfg, ingest_chunk_bytes=DEFAULT_STREAMING_CHUNK_BYTES)
    return cfg


def count_kmers_streaming(path: str | os.PathLike, k: int) -> dict[str, int]:
    """Count in bounded-memory chunks — genome may exceed host/device memory
    (reference: src/streaming.rs:95-120, which despite the name parses the
    whole file eagerly; this one actually streams)."""
    return _count_path(path, k, config=_streaming_config()).to_string_dict()


def count_kmers_streaming_packed(path: str | os.PathLike, k: int) -> dict[int, int]:
    """Packed-key variant, avoiding string materialization
    (reference: src/streaming.rs:158-167)."""
    return _count_path(path, k, config=_streaming_config()).to_packed_dict()


def count_kmers_packed(path: str | os.PathLike, k: int) -> dict[int, int]:
    """Packed-key batch count."""
    return _count_path(path, k).to_packed_dict()


def count_kmers_sequential(path: str | os.PathLike, k: int) -> dict[str, int]:
    """Record-at-a-time single-pass count (reference: src/streaming.rs:677-789)."""
    resolved = SequenceFormat.AUTO.resolve(path)
    data = read_input_bytes(path)
    records = parse_records(data, resolved)
    return SequentialEngine().count_records(records, KmerLength(k).get()).to_string_dict()


def count_kmers_from_reader(
    reader: BinaryIO | TextIO,
    k: int,
    fmt: SequenceFormat = SequenceFormat.FASTA,
    config: EngineConfig | None = None,
) -> dict[str, int]:
    """Count from any readable stream (reference: src/streaming.rs:513-616)."""
    return count_kmers_from_reader_packed_result(
        reader, k, fmt, config
    ).to_string_dict()


def count_kmers_from_reader_packed(
    reader: BinaryIO | TextIO,
    k: int,
    fmt: SequenceFormat = SequenceFormat.FASTA,
    config: EngineConfig | None = None,
) -> dict[int, int]:
    return count_kmers_from_reader_packed_result(
        reader, k, fmt, config
    ).to_packed_dict()


def count_kmers_from_reader_packed_result(
    reader: BinaryIO | TextIO,
    k: int,
    fmt: SequenceFormat = SequenceFormat.FASTA,
    config: EngineConfig | None = None,
) -> PackedCounts:
    """Bounded-memory count from an open stream: the reader is consumed in
    record-aligned chunks, never whole, so pipes larger than RAM work
    (reference's BufRead loop: src/streaming.rs:513-616, 538-557)."""
    from .io.reader import stream_reader_chunks
    from .models.engines import count_chunked_streams

    cfg = config or EngineConfig()
    chunk_bytes = cfg.ingest_chunk_bytes or DEFAULT_STDIN_CHUNK_BYTES
    chunks = stream_reader_chunks(reader, fmt.resolve(None), chunk_bytes)
    return count_chunked_streams(chunks, KmerLength(k).get(), config=cfg)


def count_kmers_stdin(k: int) -> dict[str, int]:
    """Count from stdin, default FASTA (reference: src/streaming.rs:315-332)."""
    return count_kmers_stdin_with_format(k, SequenceFormat.AUTO)


def count_kmers_stdin_with_format(k: int, fmt: SequenceFormat) -> dict[str, int]:
    resolved = fmt.resolve(None)
    return count_kmers_from_reader(sys.stdin.buffer, k, resolved)


def count_kmers_stdin_packed(k: int) -> dict[int, int]:
    """Packed-key stdin count (reference: src/streaming.rs:349-353)."""
    return count_kmers_from_reader_packed(
        sys.stdin.buffer, k, SequenceFormat.AUTO.resolve(None)
    )


def count_kmers_from_input(input_: Input, k: int) -> dict[str, int]:
    """Count from an :class:`Input` source — file or stdin
    (reference: src/streaming.rs:477-485)."""
    if input_.is_stdin:
        return count_kmers_stdin(k)
    return count_kmers_streaming(input_.path, k)


def count_kmers_from_input_packed(input_: Input, k: int) -> dict[int, int]:
    """Packed-key :func:`count_kmers_from_input`
    (reference: src/streaming.rs:501-509)."""
    if input_.is_stdin:
        return count_kmers_stdin_packed(k)
    return count_kmers_streaming_packed(input_.path, k)


def count_kmers_from_sequences(
    sequences: Iterable[bytes | str], k: int
) -> dict[str, int]:
    """Count over in-memory sequences (reference: src/streaming.rs:423-509)."""
    streams = streams_from_sequences(list(sequences))
    return count_streams(streams, KmerLength(k).get()).to_string_dict()


def count_kmers_from_sequences_packed(
    sequences: Iterable[bytes | str], k: int
) -> dict[int, int]:
    streams = streams_from_sequences(list(sequences))
    return count_streams(streams, KmerLength(k).get()).to_packed_dict()


# --- run-and-print API (reference: src/run.rs:66-200) --------------------------------


def run(path: str | os.PathLike, k: int) -> None:
    """Count and print in the default format (reference: src/run.rs:66-96)."""
    run_with_options(path, k, OutputFormat.FASTA, 1)


def run_with_options(
    path: str | os.PathLike,
    k: int,
    fmt: OutputFormat,
    min_count: int = 1,
    out: TextIO | None = None,
) -> None:
    """Count and print with format/min-count (reference: src/run.rs:131-160)."""
    counts = count_kmers(path, k)
    output_counts(counts, fmt, min_count, out)


def run_with_input(
    input_: Input, k: int, fmt: OutputFormat, min_count: int = 1,
    out: TextIO | None = None,
) -> None:
    """Count from an Input (file or stdin) and print
    (reference: src/run.rs:163-180)."""
    run_with_quality(input_, k, fmt, min_count, SequenceFormat.AUTO, None, out)


def run_with_input_format(
    input_: Input,
    k: int,
    fmt: OutputFormat,
    min_count: int,
    input_format: SequenceFormat,
    out: TextIO | None = None,
) -> None:
    run_with_quality(input_, k, fmt, min_count, input_format, None, out)


def run_with_quality(
    input_: Input,
    k: int,
    fmt: OutputFormat,
    min_count: int,
    input_format: SequenceFormat,
    min_quality: int | None,
    out: TextIO | None = None,
    config: EngineConfig | None = None,
) -> None:
    """Full-option run (reference: src/run.rs:185-200). Stdin does not support
    quality filtering (reference: src/run.rs:193-198)."""
    counts = count_with_input(input_, k, input_format, min_quality, config)
    output_packed(counts, fmt, min_count, out)


def count_with_input(
    input_: Input,
    k: int,
    input_format: SequenceFormat = SequenceFormat.AUTO,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
    progress: ProgressCallback | None = None,
) -> PackedCounts:
    """Count from an :class:`Input`, returning the packed result."""
    if input_.is_stdin:
        # stdin path: quality filtering unsupported (reference: src/run.rs:193-198)
        return _count_path(None, k, input_format, None, config, progress)
    return _count_path(input_.path, k, input_format, min_quality, config, progress)
