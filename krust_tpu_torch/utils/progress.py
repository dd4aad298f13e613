"""Progress tracking (reference: src/progress.rs:26-116).

The reference fires a callback after every sequence from rayon workers; the
tensor pipeline processes batches, so callbacks fire per processed batch with
cumulative totals — same Progress payload, coarser cadence (documented
behavior difference; totals are exact).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class Progress:
    """A point-in-time progress snapshot."""

    sequences_processed: int
    bases_processed: int


class ProgressTracker:
    """Thread-safe cumulative counters for sequences and bases."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sequences = 0
        self._bases = 0

    def record_sequence(self, bases: int) -> None:
        with self._lock:
            self._sequences += 1
            self._bases += bases

    def record_batch(self, sequences: int, bases: int) -> None:
        with self._lock:
            self._sequences += sequences
            self._bases += bases

    def snapshot(self) -> Progress:
        with self._lock:
            return Progress(self._sequences, self._bases)

    def reset(self) -> None:
        with self._lock:
            self._sequences = 0
            self._bases = 0
