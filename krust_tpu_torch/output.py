"""Output formatting (reference: src/run.rs:441-486, src/cli.rs:90-101).

Formats:
  fasta      ``>{count}\\n{kmer}`` per entry
  tsv        ``{kmer}\\t{count}`` per entry
  json       pretty-printed array of ``{"kmer": ..., "count": ...}``
  histogram  ``{count}\\t{frequency}`` ascending by count, computed AFTER
             min-count filtering (reference: src/run.rs:471-481)

Entry order for fasta/tsv/json is unspecified in the reference (HashMap
iteration); we emit insertion order of the mapping we're given.
"""

from __future__ import annotations

import enum
import io
import json
import sys
from typing import IO, Mapping, TextIO

import numpy as np

from .histogram import compute_histogram, compute_histogram_array


class OutputFormat(enum.Enum):
    FASTA = "fasta"
    TSV = "tsv"
    JSON = "json"
    HISTOGRAM = "histogram"

    def __str__(self) -> str:
        return self.value


def output_counts(
    counts: Mapping[str, int],
    fmt: OutputFormat = OutputFormat.FASTA,
    min_count: int = 1,
    out: TextIO | None = None,
) -> None:
    """Write counts to ``out`` (default stdout) in the requested format.

    ``min_count`` filters entries below the threshold at output time
    (reference: src/run.rs:447-450).
    """
    out = out if out is not None else sys.stdout
    filtered = (
        counts
        if min_count <= 1
        else {kmer: c for kmer, c in counts.items() if c >= min_count}
    )

    if fmt is OutputFormat.FASTA:
        chunks = [f">{c}\n{kmer}\n" for kmer, c in filtered.items()]
        out.write("".join(chunks))
    elif fmt is OutputFormat.TSV:
        chunks = [f"{kmer}\t{c}\n" for kmer, c in filtered.items()]
        out.write("".join(chunks))
    elif fmt is OutputFormat.JSON:
        data = [{"kmer": kmer, "count": c} for kmer, c in filtered.items()]
        json.dump(data, out, indent=2)
        out.write("\n")
    elif fmt is OutputFormat.HISTOGRAM:
        hist = compute_histogram(filtered)
        chunks = [f"{c}\t{f}\n" for c, f in hist.items()]
        out.write("".join(chunks))
    else:  # pragma: no cover
        raise ValueError(f"unknown output format: {fmt}")
    out.flush()


# --- vectorized array output path -------------------------------------------------


def _fill_digit_columns(
    out: np.ndarray, col0: int, vals: np.ndarray, width: int
) -> None:
    """Write ``width``-digit decimals into ``out[:, col0:col0+width]``."""
    # 32-bit divmod is ~2x faster and covers any count with <= 9 digits
    v = vals.astype(np.uint32 if width <= 9 else np.uint64)
    ten = v.dtype.type(10)
    for i in range(width - 1, -1, -1):
        out[:, col0 + i] = (v % ten).astype(np.uint8) + 48
        v = v // ten


def _digit_groups(counts: np.ndarray):
    """Yield (mask, width) partitioning entries by decimal digit count."""
    widths = np.ones(counts.shape[0], np.int8)
    bound = np.uint64(10)
    for _ in range(19):  # u64 max has 20 digits
        more = counts >= bound
        if not more.any():
            break
        widths += more
        bound *= np.uint64(10)
    for w in np.unique(widths):
        yield widths == w, int(w)


def _histogram_bytes(hist: Mapping[int, int]) -> bytes:
    return "".join(f"{c}\t{f}\n" for c, f in hist.items()).encode()


def format_packed_counts(
    codes: np.ndarray,
    counts: np.ndarray,
    k: int,
    fmt: OutputFormat = OutputFormat.FASTA,
    min_count: int = 1,
) -> bytes:
    """Render (codes, counts) arrays to output bytes with zero per-entry
    Python — numpy byte assembly only (reference: src/run.rs:441-486, with
    the parallel unpack of src/run.rs:573-583 folded in).

    Entry order is unspecified by the reference (HashMap iteration); this
    path emits ascending code order within ascending count-digit-width
    groups. Byte-identical row syntax to :func:`output_counts`.
    """
    from .kmer import fill_kmer_columns

    codes = np.asarray(codes, np.uint64)
    counts = np.asarray(counts, np.uint64)
    if min_count > 1:
        keep = counts >= np.uint64(min_count)
        codes, counts = codes[keep], counts[keep]

    if fmt is OutputFormat.HISTOGRAM:
        return _histogram_bytes(compute_histogram_array(counts))

    if codes.shape[0] == 0:
        return b"[]\n" if fmt is OutputFormat.JSON else b""

    # row layouts: literal bytes interleaved with the kmer / digit fields
    if fmt is OutputFormat.TSV:
        layout = [None, b"\t", -1, b"\n"]  # None=kmer, -1=digits
    elif fmt is OutputFormat.FASTA:
        layout = [b">", -1, b"\n", None, b"\n"]
    elif fmt is OutputFormat.JSON:
        layout = [
            b'  {\n    "kmer": "', None, b'",\n    "count": ', -1, b"\n  },\n",
        ]
    else:  # pragma: no cover
        raise ValueError(f"unknown output format: {fmt}")

    chunks: list[bytes] = []
    for mask, w in _digit_groups(counts):
        g_codes = codes[mask]
        g_counts = counts[mask]
        n = g_codes.shape[0]
        row = sum(len(f) if isinstance(f, bytes) else (k if f is None else w)
                  for f in layout)
        out = np.empty((n, row), np.uint8)
        col = 0
        for f in layout:
            if isinstance(f, bytes):
                out[:, col : col + len(f)] = np.frombuffer(f, np.uint8)
                col += len(f)
            elif f is None:
                fill_kmer_columns(out, col, g_codes, k)
                col += k
            else:
                _fill_digit_columns(out, col, g_counts, w)
                col += w
        chunks.append(out.tobytes())

    blob = b"".join(chunks)
    if fmt is OutputFormat.JSON:
        # drop the final ",\n", wrap in the array brackets (byte-identical
        # to json.dump(..., indent=2) + "\n")
        return b"[\n" + blob[:-2] + b"\n]\n"
    return blob


def output_packed(
    result,
    fmt: OutputFormat = OutputFormat.FASTA,
    min_count: int = 1,
    out: IO | None = None,
) -> None:
    """Write a :class:`~krust_tpu_torch.models.engines.PackedCounts` directly.

    The CLI/bulk output path: bytes go straight to the binary stream
    (default ``sys.stdout.buffer``), never through per-k-mer strings.
    """
    if fmt is OutputFormat.HISTOGRAM and result.histogram is not None:
        # the count-of-counts the device took at the pull: bins below
        # min_count dropped, as filtering the counts first would
        hist = result.histogram if min_count <= 1 else result.histogram.at_least(min_count)
        data = _histogram_bytes(compute_histogram_array(hist))
    else:
        data = format_packed_counts(result.codes, result.counts, result.k, fmt, min_count)
    if out is None:
        # default stdout: bytes straight to the binary layer
        sys.stdout.buffer.write(data)
        sys.stdout.flush()
        return
    # caller-supplied stream: respect ITS text/binary nature — writing
    # beneath a text wrapper's encoder would corrupt non-ASCII encodings
    # and reorder pending buffered text
    if isinstance(out, io.TextIOBase) or hasattr(out, "encoding"):
        out.write(data.decode("ascii"))
    else:
        out.write(data)
    out.flush()
