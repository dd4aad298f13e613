"""Fluent builder API (reference: src/builder.rs:62-551).

The counting methods reach the same engines as :mod:`krust_tpu_torch.api`:
the device engine on the card unless ``engine_config`` asks for the CPU
(``EngineConfig(device="cpu")``). The multi-device ``count_sharded`` of
``krust_tpu`` is not ported yet (ROADMAP A10).

Example::

    from krust_tpu_torch import KmerCounter

    counts = (
        KmerCounter.new()
        .k(21)
        .min_count(2)
        .input_format(SequenceFormat.FASTQ)
        .min_quality(20)
        .count("reads.fq")
    )
"""

from __future__ import annotations

import os
from typing import Callable, TextIO

from . import api
from .errors import BuilderError
from .histogram import compute_histogram
from .io.format import SequenceFormat
from .io.input import Input
from .kmer import KmerLength
from .output import OutputFormat, output_packed
from .utils.config import EngineConfig
from .utils.progress import Progress


class KmerCounter:
    """Configurable k-mer counter with chained setters.

    ``min_count`` filters results post-count (reference: src/builder.rs:251-258);
    ``format`` only affects the printing entry points.
    """

    def __init__(self) -> None:
        self._k: KmerLength | None = None
        self._min_count: int = 1
        self._format: OutputFormat = OutputFormat.FASTA
        self._input_format: SequenceFormat = SequenceFormat.AUTO
        self._min_quality: int | None = None
        self._config: EngineConfig = EngineConfig()

    # --- construction -----------------------------------------------------------

    @classmethod
    def new(cls) -> "KmerCounter":
        return cls()

    # --- setters (all return self) ------------------------------------------------

    def k(self, k: int) -> "KmerCounter":
        """Set k (validates 1..=32; raises KmerLengthError)."""
        self._k = KmerLength(k)
        return self

    def min_count(self, min_count: int) -> "KmerCounter":
        self._min_count = int(min_count)
        return self

    def format(self, fmt: OutputFormat) -> "KmerCounter":
        self._format = fmt
        return self

    def input_format(self, fmt: SequenceFormat) -> "KmerCounter":
        self._input_format = fmt
        return self

    def min_quality(self, q: int | None) -> "KmerCounter":
        if q is not None and not 0 <= q <= 93:
            raise BuilderError(f"min_quality must be in 0..=93, got {q}")
        self._min_quality = q
        return self

    def engine_config(self, config: EngineConfig) -> "KmerCounter":
        self._config = config
        return self

    # --- getters (reference: src/builder.rs getters) -------------------------------

    def get_k(self) -> KmerLength | None:
        return self._k

    def get_min_count(self) -> int:
        return self._min_count

    def get_format(self) -> OutputFormat:
        return self._format

    def get_input_format(self) -> SequenceFormat:
        return self._input_format

    def get_min_quality(self) -> int | None:
        return self._min_quality

    # --- execution ------------------------------------------------------------------

    def _require_k(self) -> int:
        if self._k is None:
            raise BuilderError("k-mer length not set: call .k(<1..=32>) first")
        return self._k.get()

    def _filtered(self, counts: dict[str, int]) -> dict[str, int]:
        if self._min_count <= 1:
            return counts
        return {km: c for km, c in counts.items() if c >= self._min_count}

    def count(self, path: str | os.PathLike) -> dict[str, int]:
        """Count k-mers, applying min-count filtering
        (reference: src/builder.rs:232-262)."""
        k = self._require_k()
        counts = api._count_path(
            path, k, self._input_format, self._min_quality, self._config
        ).to_string_dict()
        return self._filtered(counts)

    def count_packed(self, path: str | os.PathLike) -> dict[int, int]:
        k = self._require_k()
        result = api._count_path(path, k, self._input_format, self._min_quality, self._config)
        return self._filtered(result.to_packed_dict())

    def count_streaming(self, path: str | os.PathLike) -> dict[str, int]:
        """Bounded-memory chunked count (reference: src/builder.rs
        count_streaming — whose engine is eager; this one streams unless the
        builder config pins ``ingest_chunk_bytes`` otherwise)."""
        k = self._require_k()
        counts = api._count_path(
            path,
            k,
            self._input_format,
            self._min_quality,
            api._streaming_config(self._config),
        ).to_string_dict()
        return self._filtered(counts)

    def count_mmap(self, path: str | os.PathLike) -> dict[str, int]:
        """Memory-mapped count (reference: src/builder.rs count_mmap)."""
        k = self._require_k()
        return self._filtered(api.count_kmers_mmap(path, k, self._config))

    def count_with_progress(
        self, path: str | os.PathLike, callback: Callable[[Progress], None]
    ) -> dict[str, int]:
        k = self._require_k()
        counts = api._count_path(
            path, k, self._input_format, self._min_quality, self._config, callback
        ).to_string_dict()
        return self._filtered(counts)

    def histogram(self, path: str | os.PathLike) -> dict[int, int]:
        """Count-of-counts spectrum after min-count filtering
        (reference: src/builder.rs histogram)."""
        return compute_histogram(self.count(path))

    def run(self, path: str | os.PathLike, out: TextIO | None = None) -> None:
        """Count and print in the configured format
        (reference: src/builder.rs run)."""
        k = self._require_k()
        result = api._count_path(
            path, k, self._input_format, self._min_quality, self._config
        )
        output_packed(result, self._format, self._min_count, out)

    def count_to_writer(self, path: str | os.PathLike, out: TextIO) -> None:
        """Count and write to a supplied writer
        (reference: src/builder.rs count_to_writer)."""
        self.run(path, out)

    def run_input(self, input_: Input, out: TextIO | None = None) -> None:
        k = self._require_k()
        api.run_with_quality(
            input_, k, self._format, self._min_count,
            self._input_format, self._min_quality, out,
            config=self._config,
        )
