"""Binary .kmix k-mer index: save, load, query (reference: src/index.rs).

Byte-exact with the reference's format version 1 so indexes are portable in
both directions (reference: src/index.rs:7-29):

    +--------+--------+------+--------+------------------+--------+
    | MAGIC  | VERSION|  K   | COUNT  |      DATA        | CRC32  |
    | 4 bytes| 1 byte |1 byte| 8 bytes| 16 bytes x COUNT | 4 bytes|
    +--------+--------+------+--------+------------------+--------+

    MAGIC   "KMIX"; VERSION 1; K in 1..=32; COUNT little-endian u64;
    DATA    (packed: u64 LE, count: u64 LE) pairs;
    CRC32   IEEE (poly 0xEDB88320) over all preceding bytes, little-endian.

``.gz`` paths are gzip-compressed/decompressed transparently, selected purely
by extension (reference: src/index.rs:465-469). Entries are written sorted by
packed key for determinism; the reference accepts any order on load.
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib

import numpy as np

from .errors import IndexReadError, IndexWriteError, InvalidIndexError
from .io.format import is_gzip_path
from .kmer import KmerLength

MAGIC = b"KMIX"
VERSION = 1
_HEADER = struct.Struct("<4sBBQ")  # magic, version, k, count
_MIN_SIZE = 18  # header (14) + crc (4)


class KmerIndex:
    """Packed canonical k-mer -> count mapping (reference: src/index.rs:68-133).

    Array-backed: keys live in one sorted uint64 numpy array, values in a
    parallel array (lookups are binary search). A dict never materializes
    unless a caller reads the :attr:`counts` compatibility property — for a
    16M-entry index built from device results that saves seconds and GBs
    versus a Python dict of boxed ints.
    """

    def __init__(
        self,
        k: KmerLength | int,
        counts: dict[int, int] | None = None,
        *,
        codes: np.ndarray | None = None,
        values: np.ndarray | None = None,
    ):
        self._k = k if isinstance(k, KmerLength) else KmerLength(k)
        if counts is not None:
            n = len(counts)
            c = np.fromiter(counts.keys(), dtype=np.uint64, count=n)
            v = np.fromiter(counts.values(), dtype=np.uint64, count=n)
        else:
            c = np.asarray(codes if codes is not None else [], dtype=np.uint64)
            v = np.asarray(values if values is not None else [], dtype=np.uint64)
        if c.shape != v.shape:
            raise ValueError("codes and values must have equal length")
        if c.shape[0] and not np.all(c[:-1] <= c[1:]):
            order = np.argsort(c, kind="stable")
            c, v = c[order], v[order]
        if c.shape[0] > 1:
            dup = c[1:] == c[:-1]
            if dup.any():
                # last-wins dedup: stable sort keeps input order within equal
                # keys, so this matches the dict-built path (and therefore
                # serialize/deserialize round-trips) exactly
                keep = np.append(c[:-1] != c[1:], True)
                c, v = c[keep], v[keep]
        self._codes = np.ascontiguousarray(c)
        self._values = np.ascontiguousarray(v)
        self._dict: dict[int, int] | None = None

    @classmethod
    def from_arrays(
        cls, k: KmerLength | int, codes: np.ndarray, values: np.ndarray
    ) -> "KmerIndex":
        """Build directly from (codes, counts) arrays — the device-result path."""
        return cls(k, codes=codes, values=values)

    @property
    def k(self) -> KmerLength:
        return self._k

    @property
    def codes(self) -> np.ndarray:
        """Sorted uint64 packed keys."""
        return self._codes

    @property
    def values(self) -> np.ndarray:
        """Counts aligned with :attr:`codes`."""
        return self._values

    @property
    def counts(self) -> dict[int, int]:
        """Dict view (compatibility; materialized lazily, then cached)."""
        if self._dict is None:
            self._dict = dict(zip(self._codes.tolist(), self._values.tolist()))
        return self._dict

    def __len__(self) -> int:
        return int(self._codes.shape[0])

    def len(self) -> int:
        """Entry count (reference: src/index.rs:94-96); same as len(self)."""
        return len(self)

    def is_empty(self) -> bool:
        return self._codes.shape[0] == 0

    def into_counts(self) -> dict[int, int]:
        """The packed counts as a dict the caller OWNS (reference:
        src/index.rs:112-114 is consuming — callers may mutate freely, so
        this returns a copy rather than the index's cache)."""
        return dict(self.counts)

    def get(self, packed_bits: int) -> int | None:
        """Look up a canonical packed k-mer; None when absent."""
        i = int(np.searchsorted(self._codes, np.uint64(packed_bits)))
        if i < self._codes.shape[0] and self._codes[i] == np.uint64(packed_bits):
            return int(self._values[i])
        return None

    def to_string_counts(self) -> dict[str, int]:
        from .kmer import unpack_many

        strings = unpack_many(self._codes, self._k)
        return dict(zip(strings, self._values.tolist()))


def serialize_index(index: KmerIndex) -> bytes:
    """Serialize to the raw (uncompressed) byte format."""
    n = len(index)
    body = bytearray(_HEADER.size + 16 * n + 4)
    _HEADER.pack_into(body, 0, MAGIC, VERSION, index.k.get(), n)
    if n:
        pairs = np.empty((n, 2), dtype="<u8")
        pairs[:, 0] = index.codes  # already sorted
        pairs[:, 1] = index.values
        body[_HEADER.size : _HEADER.size + 16 * n] = pairs.tobytes()
    crc = zlib.crc32(bytes(body[:-4])) & 0xFFFFFFFF
    struct.pack_into("<I", body, len(body) - 4, crc)
    return bytes(body)


def deserialize_index(data: bytes, path: str | None = None) -> KmerIndex:
    """Parse and validate raw index bytes (reference: src/index.rs:282-401).

    Validation order matches the reference: size, magic, CRC, version, k,
    count, data size.
    """
    if len(data) < _MIN_SIZE:
        raise InvalidIndexError("file too small", path)
    if data[:4] != MAGIC:
        raise InvalidIndexError("bad magic bytes (not a .kmix index)", path)
    (stored_crc,) = struct.unpack_from("<I", data, len(data) - 4)
    actual_crc = zlib.crc32(data[:-4]) & 0xFFFFFFFF
    if stored_crc != actual_crc:
        raise InvalidIndexError(
            f"CRC32 mismatch (stored {stored_crc:#010x}, computed {actual_crc:#010x})",
            path,
        )
    _, version, k_raw, count = _HEADER.unpack_from(data, 0)
    if version != VERSION:
        raise InvalidIndexError(f"unsupported version {version}", path)
    try:
        k = KmerLength(k_raw)
    except Exception:
        raise InvalidIndexError(f"invalid k={k_raw}", path) from None
    expect = _HEADER.size + 16 * count + 4
    if len(data) != expect:
        raise InvalidIndexError(
            f"size mismatch: {len(data)} bytes, expected {expect} for {count} entries",
            path,
        )
    if count:
        pairs = np.frombuffer(
            data, dtype="<u8", count=2 * count, offset=_HEADER.size
        ).reshape(count, 2)
        codes, values = pairs[:, 0], pairs[:, 1]
        if count > 1 and not np.all(codes[:-1] < codes[1:]):
            # unsorted or duplicate keys (we always write sorted-unique, but
            # the reference accepts any order): last occurrence wins,
            # matching the reference's HashMap insertion semantics on load
            counts = dict(zip(codes.tolist(), values.tolist()))
            return KmerIndex(k, counts)
        return KmerIndex.from_arrays(k, codes, values)
    return KmerIndex.from_arrays(
        k, np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    )


def save_index(index: KmerIndex, path: str | os.PathLike) -> None:
    """Write an index to disk, gzip-compressing for ``.gz`` paths
    (reference: src/index.rs:156-176)."""
    raw = serialize_index(index)
    try:
        if is_gzip_path(path):
            with gzip.open(path, "wb") as f:
                f.write(raw)
        else:
            with open(path, "wb") as f:
                f.write(raw)
    except OSError as e:
        raise IndexWriteError(f"failed to write index {path}: {e}") from e


def load_index(path: str | os.PathLike) -> KmerIndex:
    """Read an index from disk (reference: src/index.rs:199-219)."""
    try:
        if is_gzip_path(path):
            with gzip.open(path, "rb") as f:
                data = f.read()
        else:
            with open(path, "rb") as f:
                data = f.read()
    except (OSError, EOFError) as e:
        # EOFError: truncated gzip stream (not an OSError subclass)
        raise IndexReadError(f"failed to read index {path}: {e}") from e
    return deserialize_index(data, str(path))
