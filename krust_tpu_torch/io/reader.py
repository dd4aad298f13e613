"""Sequence readers: FASTA/FASTQ (+gzip) from file, stdin, or bytes.

Equivalent of the reference reader layer (reference: src/reader.rs:82-247,
src/mmap.rs:29-71) redesigned for a tensor pipeline: besides record-level
parsing, :func:`parse_to_streams` converts an entire input to a flat base-code
stream with one separator byte between records — the shape the device codec
wants — using only vectorized numpy passes (no per-record Python loop).

Parsing semantics follow the reference's rust-bio backend:
- FASTA: ``>`` header lines; multi-line records concatenate
  (reference: tests/library_tests.rs:233-241); content before the first
  header is an error; empty input yields zero records.
- FASTQ: strict 4-line records (``@`` header, sequence, ``+`` separator,
  quality); sequence/quality length mismatch is an error.
- ``\\r`` is stripped (CRLF tolerated); gzip is selected purely by the
  ``.gz`` extension (reference: src/format.rs:47-70).
"""

from __future__ import annotations

import gzip
import os
import stat
import sys
from dataclasses import dataclass

import numpy as np

from ..errors import FormatError, ReadError
from ..kmer import BASE_LUT, INVALID_CODE
from .format import SequenceFormat, is_gzip_path

_NL = 10  # \n
_CR = 13  # \r
_GT = 62  # >
_AT = 64  # @
_PLUS = 43  # +


@dataclass
class SequenceWithQuality:
    """A record's sequence bytes plus optional quality bytes
    (reference: src/reader.rs:13-16)."""

    seq: bytes
    qual: bytes | None = None


@dataclass
class ParsedStreams:
    """Flat parse result ready for the packer.

    ``codes``: uint8 base codes (0..3) with INVALID_CODE separators between
    records (and for every non-ACGT input byte). ``qual``: aligned quality
    bytes (0xFF at separator positions) or None for FASTA. ``n_records`` /
    ``n_bases`` feed progress reporting.
    """

    codes: np.ndarray
    qual: np.ndarray | None
    n_records: int
    n_bases: int


# --- raw byte acquisition ------------------------------------------------------


def read_input_bytes(path: str | os.PathLike | None) -> bytes:
    """Read a file (gunzipping by ``.gz`` extension) or stdin into bytes."""
    if path is None:
        data = sys.stdin.buffer.read()
        return data
    try:
        if is_gzip_path(path):
            with gzip.open(path, "rb") as f:
                return f.read()
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        raise
    except (OSError, EOFError) as e:
        # EOFError: truncated gzip stream (not an OSError subclass)
        raise ReadError(str(e), str(path)) from e


# --- line scaffolding ----------------------------------------------------------


def _line_table(arr: np.ndarray):
    """Split a byte array into lines.

    Returns (starts, ends, first_bytes) where line i is arr[starts[i]:ends[i]]
    with the trailing ``\\r`` already excluded from ``ends``. A trailing empty
    line (from a final newline) is dropped; interior blank lines are kept so
    format validation can reject them.
    """
    n = arr.shape[0]
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return empty, empty, np.zeros(0, dtype=np.uint8)
    nl = np.flatnonzero(arr == _NL)
    starts = np.empty(nl.shape[0] + 1, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl + 1
    ends = np.empty_like(starts)
    ends[:-1] = nl
    ends[-1] = n
    # strip \r at line end
    has_cr = (ends > starts) & (arr[np.maximum(ends - 1, 0)] == _CR)
    ends = ends - has_cr.astype(np.int64)
    # drop the single trailing empty line produced by a final newline
    if starts.shape[0] > 0 and starts[-1] >= ends[-1]:
        starts, ends = starts[:-1], ends[:-1]
    if starts.shape[0] == 0:
        return starts, ends, np.zeros(0, dtype=np.uint8)
    first = arr[np.minimum(starts, n - 1)]
    first = np.where(ends > starts, first, 0).astype(np.uint8)
    return starts, ends, first


def _gather_lines(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate the given lines into one contiguous byte array.

    Returns (flat_bytes, per_line_lengths). Vectorized: builds a single index
    array with a repeat/cumsum trick instead of per-line slicing.
    """
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8), lens
    # index[j] = starts[line(j)] + offset_within_line(j)
    line_of = np.repeat(np.arange(lens.shape[0]), lens)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.concatenate(([0], np.cumsum(lens)[:-1])), lens
    )
    idx = starts[line_of] + offs
    return arr[idx], lens


# --- FASTA ---------------------------------------------------------------------


def _parse_fasta(arr: np.ndarray):
    """Returns (seq_flat, rec_lens): concatenated sequence bytes and per-record
    lengths, in file order."""
    starts, ends, first = _line_table(arr)
    if starts.shape[0] == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    is_header = first == _GT
    nonempty = ends > starts
    if nonempty.any() and not is_header[int(np.argmax(nonempty))]:
        raise FormatError("FASTA input does not start with a '>' header line")
    if not nonempty.any():
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    # drop anything before the first header (only blank lines can be there)
    first_header = int(np.argmax(is_header))
    starts, ends, is_header = (
        starts[first_header:],
        ends[first_header:],
        is_header[first_header:],
    )
    seq_mask = ~is_header
    seq_flat, line_lens = _gather_lines(arr, starts[seq_mask], ends[seq_mask])
    # record id per sequence line: number of headers before it, minus 1
    rec_of_line = np.cumsum(is_header.astype(np.int64))[seq_mask] - 1
    n_rec = int(is_header.sum())
    rec_lens = np.zeros(n_rec, dtype=np.int64)
    np.add.at(rec_lens, rec_of_line, line_lens)
    return seq_flat, rec_lens


# --- FASTQ ---------------------------------------------------------------------


def _parse_fastq(arr: np.ndarray):
    """Returns (seq_flat, qual_flat, rec_lens)."""
    starts, ends, first = _line_table(arr)
    n_lines = starts.shape[0]
    if n_lines == 0:
        return (
            np.zeros(0, dtype=np.uint8),
            np.zeros(0, dtype=np.uint8),
            np.zeros(0, dtype=np.int64),
        )
    if n_lines % 4 != 0:
        raise FormatError(
            f"FASTQ input has {n_lines} lines; expected a multiple of 4"
        )
    if not np.all(first[0::4] == _AT):
        raise FormatError("FASTQ record header does not start with '@'")
    if not np.all(first[2::4] == _PLUS):
        raise FormatError("FASTQ separator line does not start with '+'")
    seq_lens = (ends[1::4] - starts[1::4]).astype(np.int64)
    qual_lens = (ends[3::4] - starts[3::4]).astype(np.int64)
    if not np.array_equal(seq_lens, qual_lens):
        raise FormatError("FASTQ sequence and quality lengths differ")
    seq_flat, _ = _gather_lines(arr, starts[1::4], ends[1::4])
    qual_flat, _ = _gather_lines(arr, starts[3::4], ends[3::4])
    return seq_flat, qual_flat, seq_lens


# --- public record-level API ----------------------------------------------------


def parse_records(data: bytes, fmt: SequenceFormat) -> list[SequenceWithQuality]:
    """Parse raw bytes into records (sequence + optional quality)."""
    arr = np.frombuffer(data, dtype=np.uint8)
    if fmt.resolve(None).is_fastq:
        seq_flat, qual_flat, rec_lens = _parse_fastq(arr)
        if rec_lens.shape[0] == 0:
            return []
        bounds = np.cumsum(rec_lens)[:-1]
        seqs = np.split(seq_flat, bounds)
        quals = np.split(qual_flat, bounds)
        return [
            SequenceWithQuality(s.tobytes(), q.tobytes())
            for s, q in zip(seqs, quals)
        ]
    seq_flat, rec_lens = _parse_fasta(arr)
    if rec_lens.shape[0] == 0:
        return []
    bounds = np.cumsum(rec_lens)[:-1]
    return [SequenceWithQuality(s.tobytes(), None) for s in np.split(seq_flat, bounds)]


def read_records(
    path: str | os.PathLike | None, fmt: SequenceFormat = SequenceFormat.AUTO
) -> list[bytes]:
    """Read all records' sequence bytes (reference: src/reader.rs:82-160)."""
    resolved = fmt.resolve(path)
    data = read_input_bytes(path)
    return [r.seq for r in parse_records(data, resolved)]


def read_records_with_quality(
    path: str | os.PathLike | None, fmt: SequenceFormat = SequenceFormat.AUTO
) -> list[SequenceWithQuality]:
    """Read all records with quality (reference: src/reader.rs:167-247)."""
    resolved = fmt.resolve(path)
    data = read_input_bytes(path)
    return parse_records(data, resolved)


# --- flat stream fast path -------------------------------------------------------


def parse_to_streams(data: bytes, fmt: SequenceFormat, *, quality: bool = True) -> ParsedStreams:
    """Parse raw bytes directly into separator-delimited code/quality streams.

    The returned ``codes`` array is what the sliding-window codec consumes:
    every record's bases as 2-bit codes, with a single INVALID_CODE byte
    between consecutive records so no window spans a record boundary. This
    reproduces the reference's per-record window scan exactly (a window is
    counted iff it contains no invalid base; reference: src/run.rs:526-563)
    while letting the whole input live in one dense tensor.

    With ``quality`` false a FASTQ input still has its quality lengths
    checked, but ``qual`` is None: for a count that reads no quality.
    """
    return _parse(data, fmt, quality)[0]


def _parse(data, fmt: SequenceFormat, quality: bool) -> tuple[ParsedStreams, int]:
    """:func:`parse_to_streams` -> (streams, threads the parse ran on)."""
    fmt = fmt.resolve(None) if fmt is SequenceFormat.AUTO else fmt

    # the native range-parallel parse (the numpy path below is the exact fallback)
    from . import native

    res = native.ingest_native(data, fmt.is_fastq, quality=quality)
    if res is not None:
        codes, qual, n_rec, n_bases, threads = res
        return ParsedStreams(codes, qual, n_rec, n_bases), threads

    arr = np.frombuffer(data, dtype=np.uint8)
    if fmt.is_fastq:
        seq_flat, qual_flat, rec_lens = _parse_fastq(arr)
        n_rec = rec_lens.shape[0]
        n_bases = int(rec_lens.sum())
        if n_rec == 0:
            qual = np.zeros(0, dtype=np.uint8) if quality else None
            return ParsedStreams(np.zeros(0, dtype=np.uint8), qual, 0, 0), 1
        codes = _with_separators(BASE_LUT[seq_flat], rec_lens, INVALID_CODE)
        qual = _with_separators(qual_flat, rec_lens, 0xFF) if quality else None
        return ParsedStreams(codes, qual, n_rec, n_bases), 1
    seq_flat, rec_lens = _parse_fasta(arr)
    n_rec = rec_lens.shape[0]
    n_bases = int(rec_lens.sum())
    if n_rec == 0:
        return ParsedStreams(np.zeros(0, dtype=np.uint8), None, 0, 0), 1
    codes = _with_separators(BASE_LUT[seq_flat], rec_lens, INVALID_CODE)
    return ParsedStreams(codes, None, n_rec, n_bases), 1


def read_streams(
    path: str | os.PathLike | None, fmt: SequenceFormat, *, quality: bool = True
) -> tuple[ParsedStreams, int, bool]:
    """Read and parse a whole input -> (streams, parse threads, mapped).

    A regular, non-empty, uncompressed file is parsed straight from a
    read-only mapping (``mapped`` true) that is gone when this returns: no
    array of the result views it, and no copy of the file is made. gzip,
    stdin, FIFOs and empty files are read into bytes first. ``quality`` as
    for :func:`parse_to_streams`.
    """
    fmt = fmt.resolve(path)
    if path is None or is_gzip_path(path):
        return (*_parse(read_input_bytes(path), fmt, quality), False)
    from . import native

    try:
        with open(path, "rb") as f:
            st = os.fstat(f.fileno())
            if stat.S_ISREG(st.st_mode) and st.st_size:
                res = native.ingest_file_native(
                    f.fileno(), st.st_size, fmt.is_fastq, quality=quality
                )
                if res is not None:
                    codes, qual, n_rec, n_bases, threads = res
                    return ParsedStreams(codes, qual, n_rec, n_bases), threads, True
            data = f.read()
    except FileNotFoundError:
        raise
    except OSError as e:
        raise ReadError(str(e), str(path)) from e
    return (*_parse(data, fmt, quality), False)


def stream_input_chunks(
    path: str | os.PathLike | None,
    fmt: SequenceFormat = SequenceFormat.AUTO,
    chunk_bytes: int = 256 << 20,
):
    """Yield :class:`ParsedStreams` for consecutive record-aligned chunks.

    Bounded-host-memory ingest for inputs larger than RAM (the reference's
    true-streaming paths: src/streaming.rs:513-616, 677-789): the file (or
    gzip stream, or stdin) is read ``chunk_bytes`` at a time, each chunk is
    cut at the last complete record boundary, and the remainder carries into
    the next chunk. Records never split, and windows never span records, so
    feeding the chunks into one table is exactly equivalent to the eager
    whole-file parse.
    """
    resolved = fmt.resolve(path)
    if path is None:
        f = sys.stdin.buffer
        close = False
    else:
        try:
            f = gzip.open(path, "rb") if is_gzip_path(path) else open(path, "rb")
        except FileNotFoundError:
            raise
        except OSError as e:
            raise ReadError(str(e), str(path)) from e
        close = True
    try:
        yield from stream_reader_chunks(f, resolved, chunk_bytes, path)
    finally:
        if close:
            f.close()


def stream_reader_chunks(
    f,
    resolved: SequenceFormat,
    chunk_bytes: int = 256 << 20,
    path: str | os.PathLike | None = None,
):
    """Yield :class:`ParsedStreams` chunks from an open readable stream.

    The reader-level core of :func:`stream_input_chunks` (see its docstring
    for the exactness argument): works on any object with ``read(n)`` —
    files, pipes, sockets, ``io.BytesIO``, or text streams (decoded chunks
    are encoded back to bytes). The stream is never read whole, matching the
    reference's record-at-a-time BufRead paths
    (reference: src/streaming.rs:513-616).
    """
    # the carry accumulates as a BLOCK LIST and only the newest block is
    # ever scanned — a record longer than chunk_bytes (one chromosome)
    # costs O(record), not O(record^2/chunk) of re-copy + re-scan
    carry: list[bytes] = []
    carry_end_nl = True  # FASTA: does the carry end with '\n'?
    nl_carry = 0  # FASTQ: newlines pending in the carry (< 4)
    while True:
        try:
            block = f.read(chunk_bytes)
        except (OSError, EOFError) as e:
            raise ReadError(str(e), str(path)) from e
        if isinstance(block, str):  # text stream: back to bytes
            block = block.encode("ascii", errors="surrogateescape")
        if not block:
            if carry:
                yield parse_to_streams(b"".join(carry), resolved)
            return
        if resolved.is_fastq:
            nl_in_block = block.count(b"\n")
            groups = (nl_carry + nl_in_block) // 4
            if groups == 0:
                carry.append(block)
                nl_carry += nl_in_block
                continue
            # the closing newline is in THIS block (the carry holds < 4)
            need = 4 * groups - nl_carry
            nl_pos = np.flatnonzero(
                np.frombuffer(block, dtype=np.uint8) == _NL
            )
            cut = int(nl_pos[need - 1]) + 1
            yield parse_to_streams(b"".join(carry) + block[:cut], resolved)
            carry = [block[cut:]]
            nl_carry = nl_in_block - need
        else:
            j = block.rfind(b"\n>")
            if j >= 0:
                cut = j + 1
            elif carry and carry_end_nl and block[:1] == b">":
                cut = 0  # boundary falls exactly between carry and block
            else:
                carry.append(block)
                carry_end_nl = block.endswith(b"\n")
                continue
            yield parse_to_streams(b"".join(carry) + block[:cut], resolved)
            carry = [block[cut:]]
            carry_end_nl = block.endswith(b"\n")


def _with_separators(flat: np.ndarray, rec_lens: np.ndarray, sep: int) -> np.ndarray:
    """Insert one ``sep`` byte between consecutive records of ``flat``."""
    n_rec = rec_lens.shape[0]
    if n_rec <= 1:
        return flat.copy()
    total = flat.shape[0] + n_rec - 1
    out = np.full(total, sep, dtype=np.uint8)
    # target position of each source byte: original index + number of
    # separators inserted before it (= record index)
    rec_of = np.repeat(np.arange(n_rec, dtype=np.int64), rec_lens)
    src_idx = np.arange(flat.shape[0], dtype=np.int64)
    out[src_idx + rec_of] = flat
    return out


def streams_from_sequences(
    seqs: list[bytes | str], quals: list[bytes | None] | None = None
) -> ParsedStreams:
    """Build code/quality streams from in-memory sequences
    (reference: src/streaming.rs count_kmers_from_sequences)."""
    enc: list[bytes] = []
    for s in seqs:
        enc.append(s.encode("ascii", errors="surrogateescape") if isinstance(s, str) else bytes(s))
    if not enc:
        return ParsedStreams(np.zeros(0, dtype=np.uint8), None, 0, 0)
    rec_lens = np.array([len(s) for s in enc], dtype=np.int64)
    flat = np.frombuffer(b"".join(enc), dtype=np.uint8)
    codes = _with_separators(BASE_LUT[flat], rec_lens, INVALID_CODE)
    qual_arr = None
    if quals is not None and any(q is not None for q in quals):
        qflat_parts = []
        for s, q in zip(enc, quals):
            if q is None:
                # no quality for this record: treat as max quality
                qflat_parts.append(b"\xff" * len(s))
            else:
                if len(q) != len(s):
                    raise FormatError("sequence and quality lengths differ")
                qflat_parts.append(bytes(q))
        qflat = np.frombuffer(b"".join(qflat_parts), dtype=np.uint8)
        qual_arr = _with_separators(qflat, rec_lens, 0xFF)
    return ParsedStreams(codes, qual_arr, len(enc), int(rec_lens.sum()))
