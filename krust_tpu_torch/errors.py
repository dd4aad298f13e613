"""Error taxonomy for krust_tpu_torch.

Mirrors the reference error surface (reference: src/error.rs:10-195) with
Python exception classes instead of Rust enums. Every public API raises only
exceptions from this module (or builtins like ``FileNotFoundError`` wrapped in
:class:`KrustError` subclasses) so callers have a single hierarchy to catch.
"""

from __future__ import annotations


class KrustError(Exception):
    """Base class for all krust_tpu_torch errors (reference: src/error.rs:10-83)."""


class KmerLengthError(KrustError, ValueError):
    """Invalid k-mer length (reference: src/error.rs:86-95).

    Raised when k is outside [1, 32]; 32 is the 64-bit 2-bit-pack limit.
    """

    def __init__(self, k: int, min_k: int = 1, max_k: int = 32):
        self.k = k
        self.min = min_k
        self.max = max_k
        super().__init__(
            f"invalid k-mer length {k}: must be between {min_k} and {max_k}"
        )


class InvalidBaseError(KrustError, ValueError):
    """A non-ACGT base was found (reference: src/error.rs:98-124).

    ``base`` is the offending byte value; ``position`` is its 0-based offset
    within the candidate k-mer window. Display prints the character when
    printable, otherwise the hex byte — matching the reference's Display impl.
    """

    def __init__(self, base: int, position: int):
        self.base = base
        self.position = position
        if 0x20 <= base <= 0x7E:
            shown = f"'{chr(base)}'"
        else:
            shown = f"0x{base:02X}"
        super().__init__(f"invalid base {shown} at position {position}")


class BuilderError(KrustError, ValueError):
    """Builder misconfiguration (reference: src/error.rs:158-195)."""


class ReadError(KrustError, IOError):
    """Failure reading sequence input (files, stdin, gzip streams)."""

    def __init__(self, message: str, path: str | None = None):
        self.path = path
        super().__init__(message if path is None else f"{message}: {path}")


class FormatError(KrustError, ValueError):
    """Malformed FASTA/FASTQ content."""


class IndexError_(KrustError):
    """Base for .kmix index errors (reference: src/error.rs IndexRead/IndexWrite)."""


class IndexReadError(IndexError_, IOError):
    """Failed to read a .kmix index file."""


class IndexWriteError(IndexError_, IOError):
    """Failed to write a .kmix index file."""


class InvalidIndexError(IndexError_, ValueError):
    """A .kmix file is corrupt or not an index (bad magic/CRC/version/size).

    Reference: src/error.rs InvalidIndex + src/index.rs:282-401 validation.
    """

    def __init__(self, details: str, path: str | None = None):
        self.details = details
        self.path = path
        where = f" ({path})" if path else ""
        super().__init__(f"invalid index file{where}: {details}")
