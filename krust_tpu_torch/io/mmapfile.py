"""Memory-mapped FASTA file access.

Public zero-copy file type mirroring the reference's `MmapFasta`
(reference: src/mmap.rs:29-71): open a file read-only through the OS page
cache and expose its bytes without a heap copy. `count_kmers_mmap`
(api.py) consumes it; library users can parse the mapped bytes with any
of the reader entry points.

The usual mmap caveat applies (reference: src/mmap.rs:17-20): the
underlying file must not be modified while the mapping is active.
"""

from __future__ import annotations

import mmap as _mmap
import os


class MmapFasta:
    """A memory-mapped (FASTA) file with zero-copy byte access.

    Mirrors the reference type's surface — ``open`` / ``as_bytes`` /
    ``len`` / ``is_empty`` (reference: src/mmap.rs:29-71) — plus Python
    affordances: context-manager protocol, ``len()``, and ``close()``.
    Empty files map to an empty buffer (mmap(2) rejects zero-length maps,
    so no OS mapping is created; ``as_bytes`` is b"" either way).
    """

    def __init__(self, path: str | os.PathLike):
        self._path = os.fspath(path)
        self._file = open(self._path, "rb")
        try:
            size = os.fstat(self._file.fileno()).st_size
            self._mm: _mmap.mmap | None = (
                _mmap.mmap(self._file.fileno(), 0, access=_mmap.ACCESS_READ)
                if size
                else None
            )
        except Exception:
            self._file.close()
            raise

    @classmethod
    def open(cls, path: str | os.PathLike) -> "MmapFasta":
        """Open and memory-map a file read-only (reference: src/mmap.rs:50-57).

        Raises ``OSError`` if the file cannot be opened or mapped.
        """
        return cls(path)

    @property
    def path(self) -> str:
        return self._path

    def as_bytes(self) -> memoryview | bytes:
        """Zero-copy view of the mapped file contents
        (reference: src/mmap.rs:60-62)."""
        if self._mm is None:
            return b""
        return memoryview(self._mm)

    def len(self) -> int:
        """Mapped length in bytes (reference: src/mmap.rs:65-67).

        The MAPPING's length, not the file's current size: if the file
        grows after open, the view keeps its original extent and so does
        this (mmap.size() would re-stat the file).
        """
        return 0 if self._mm is None else len(self._mm)

    def __len__(self) -> int:
        return self.len()

    def is_empty(self) -> bool:
        """True when the mapped file has no bytes
        (reference: src/mmap.rs:70-72)."""
        return self.len() == 0

    def close(self) -> None:
        """Unmap and close the file (idempotent)."""
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if not self._file.closed:
            self._file.close()

    @property
    def closed(self) -> bool:
        return self._file.closed

    def __enter__(self) -> "MmapFasta":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self.closed else f"{self.len()} bytes"
        return f"MmapFasta({self._path!r}, {state})"
