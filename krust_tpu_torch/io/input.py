"""Input source abstraction: file path or stdin (reference: src/input.rs:27-101)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Input:
    """A sequence input source. ``path is None`` means stdin.

    ``"-"`` (or an omitted path) selects stdin, matching the reference CLI
    contract (reference: src/input.rs:55-61).
    """

    path: Path | None

    @classmethod
    def from_path(cls, path: str | os.PathLike | None) -> "Input":
        if path is None:
            return cls(None)
        p = str(path)
        if p == "-":
            return cls(None)
        return cls(Path(p))

    @classmethod
    def stdin(cls) -> "Input":
        return cls(None)

    @property
    def is_stdin(self) -> bool:
        return self.path is None

    @property
    def is_file(self) -> bool:
        return self.path is not None

    def __str__(self) -> str:
        return "<stdin>" if self.path is None else str(self.path)
