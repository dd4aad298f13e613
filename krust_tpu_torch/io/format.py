"""Sequence format detection (reference: src/format.rs:40-110).

Rules (kept byte-for-byte compatible with the reference):
- Extension-based, case-insensitive, with a ``.gz`` suffix stripped first.
- ``.fq`` / ``.fastq`` -> FASTQ; everything else (including no extension)
  -> FASTA.
- ``Auto`` resolves via the path; stdin with ``Auto`` defaults to FASTA.
"""

from __future__ import annotations

import enum
from pathlib import PurePath


class SequenceFormat(enum.Enum):
    AUTO = "auto"
    FASTA = "fasta"
    FASTQ = "fastq"

    @classmethod
    def from_extension(cls, path: str | PurePath) -> "SequenceFormat":
        p = PurePath(path)
        ext = p.suffix.lower().lstrip(".")
        if ext == "gz":
            inner = PurePath(p.stem).suffix.lower().lstrip(".")
            ext = inner
        if ext in ("fq", "fastq"):
            return cls.FASTQ
        return cls.FASTA

    @classmethod
    def from_content(cls, data: bytes) -> "SequenceFormat":
        """Content-based detection: the runtime equivalent of the reference's
        needletail backend (reference: src/reader.rs cfg(feature="needletail"),
        which sniffs record type from the first byte instead of the path).

        The first byte after any leading line terminators decides: ``>`` ->
        FASTA, ``@`` -> FASTQ. Leading spaces/tabs make the input
        undetectable (parsers require the header byte at line start).
        Anything else (or empty input) raises ValueError, matching
        needletail's rejection of headerless input
        (reference: tests/library_tests.rs:177-196).
        """
        for b in data:
            # Only line terminators may precede the header byte: the parsers
            # require '>'/'@' at line START, so an input like ' >seq' must be
            # rejected as undetectable here rather than sniffed as FASTA and
            # then failing with a confusing parse error downstream.
            if b in (0x0A, 0x0D):  # \n, \r
                continue
            if b == 0x3E:  # '>'
                return cls.FASTA
            if b == 0x40:  # '@'
                return cls.FASTQ
            break
        raise ValueError(
            "cannot detect sequence format: input does not start with '>' or '@'"
        )

    def resolve(self, path: str | PurePath | None) -> "SequenceFormat":
        """Resolve AUTO to a concrete format (reference: src/format.rs:97-102)."""
        if self is not SequenceFormat.AUTO:
            return self
        if path is None:
            return SequenceFormat.FASTA
        return SequenceFormat.from_extension(path)

    def resolve_with_content(
        self, path: str | PurePath | None, data: bytes
    ) -> "SequenceFormat":
        """Resolve AUTO by sniffing the bytes (needletail-backend behavior),
        falling back to extension rules when the content is ambiguous."""
        if self is not SequenceFormat.AUTO:
            return self
        try:
            return SequenceFormat.from_content(data)
        except ValueError:
            return self.resolve(path)

    @property
    def is_fastq(self) -> bool:
        return self is SequenceFormat.FASTQ

    @property
    def is_fasta(self) -> bool:
        return self is SequenceFormat.FASTA

    def __str__(self) -> str:
        return self.value


def is_gzip_path(path: str | PurePath) -> bool:
    """True when the path has a ``.gz`` extension (gzip is sniffed purely by
    extension, matching the reference; reference: src/index.rs:465-469)."""
    return PurePath(path).suffix.lower() == ".gz"
