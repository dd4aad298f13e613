"""Count-of-counts histogram (k-mer spectrum) (reference: src/histogram.rs).

A histogram maps occurrence-count -> number of distinct k-mers with that
count, ordered ascending by count (the reference's BTreeMap ordering;
reference: src/histogram.rs:33).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np

from .utils.tracing import span


def compute_histogram(counts: Mapping[str, int]) -> dict[int, int]:
    """Histogram from string-keyed counts (reference: src/histogram.rs:88-94)."""
    return _histogram_of_values(counts.values())


def compute_histogram_packed(counts: Mapping[int, int]) -> dict[int, int]:
    """Histogram from packed-keyed counts (reference: src/histogram.rs:110-116)."""
    return _histogram_of_values(counts.values())


class CountHistogram(NamedTuple):
    """A count-of-counts already taken, where the counts lay (the card's
    ``ops.histogram.count_histogram``): ``values`` ascending and distinct,
    ``freqs`` how many entries hold each; int64 numpy arrays."""

    values: np.ndarray
    freqs: np.ndarray

    def at_least(self, min_count: int) -> "CountHistogram":
        """The histogram of the entries whose count is ``min_count`` or more."""
        keep = self.values >= min_count
        return CountHistogram(self.values[keep], self.freqs[keep])


def compute_histogram_array(count_values) -> dict[int, int]:
    """Histogram straight from a device-produced count array (vectorized),
    or from the :class:`CountHistogram` the device took of one."""
    if isinstance(count_values, CountHistogram):
        if len(count_values.values) == 0:
            return {}
        with span("histogram", entries=int(count_values.freqs.sum()), source="device"):
            return dict(zip(count_values.values.tolist(), count_values.freqs.tolist()))
    if len(count_values) == 0:
        return {}
    with span("histogram", entries=len(count_values), source="host"):
        vals, freqs = np.unique(np.asarray(count_values), return_counts=True)
        return {int(v): int(f) for v, f in zip(vals, freqs)}


def _histogram_of_values(values) -> dict[int, int]:
    hist: dict[int, int] = {}
    for c in values:
        hist[c] = hist.get(c, 0) + 1
    return dict(sorted(hist.items()))


@dataclass(frozen=True)
class HistogramStats:
    """Summary statistics (reference: src/histogram.rs:148-169)."""

    total_kmers: int
    distinct_kmers: int
    mode_count: int
    mode_frequency: int
    mean_count: float


def histogram_stats(histogram: Mapping[int, int]) -> HistogramStats:
    """Total/distinct/mode/mean over a histogram.

    Mode ties resolve to the entry the max scan sees last among equals in
    ascending count order, matching the reference's BTreeMap max_by_key
    (last max wins on ties).
    """
    distinct = sum(histogram.values())
    total = sum(c * f for c, f in histogram.items())
    mode_count, mode_frequency = 0, 0
    for c in sorted(histogram):
        f = histogram[c]
        if f >= mode_frequency:
            mode_count, mode_frequency = c, f
    return HistogramStats(
        total_kmers=total,
        distinct_kmers=distinct,
        mode_count=mode_count,
        mode_frequency=mode_frequency,
        mean_count=(total / distinct) if distinct > 0 else 0.0,
    )
