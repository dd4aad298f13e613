"""Async counting API (reference: src/async_api.rs:73-280).

The reference offloads blocking counts to tokio's blocking pool; here the
equivalent is ``asyncio.to_thread``, which releases the event loop while the
parse + device pipeline runs in a worker thread (kernel launches are
asynchronous on the CUDA stream already).
"""

from __future__ import annotations

import asyncio
import os

from . import api
from .io.format import SequenceFormat
from .kmer import KmerLength
from .utils.config import EngineConfig


async def count_kmers_async(path: str | os.PathLike, k: int) -> dict[str, int]:
    """Async canonical k-mer count (reference: src/async_api.rs:73-92)."""
    KmerLength(k)  # validate before scheduling, like the reference
    return await asyncio.to_thread(api.count_kmers, path, k)


async def count_kmers_packed_async(path: str | os.PathLike, k: int) -> dict[int, int]:
    """Packed-key async count (reference: src/async_api.rs:95-133)."""
    KmerLength(k)
    return await asyncio.to_thread(api.count_kmers_packed, path, k)


class AsyncKmerCounter:
    """Async builder (reference: src/async_api.rs:158-280)."""

    def __init__(self) -> None:
        self._k: KmerLength | None = None
        self._min_count: int = 1
        self._input_format: SequenceFormat = SequenceFormat.AUTO
        self._min_quality: int | None = None
        self._config = EngineConfig()

    @classmethod
    def new(cls) -> "AsyncKmerCounter":
        return cls()

    def k(self, k: int) -> "AsyncKmerCounter":
        self._k = KmerLength(k)
        return self

    def min_count(self, min_count: int) -> "AsyncKmerCounter":
        self._min_count = int(min_count)
        return self

    def input_format(self, fmt: SequenceFormat) -> "AsyncKmerCounter":
        self._input_format = fmt
        return self

    def min_quality(self, q: int | None) -> "AsyncKmerCounter":
        self._min_quality = q
        return self

    async def count(self, path: str | os.PathLike) -> dict[str, int]:
        from .errors import BuilderError

        if self._k is None:
            raise BuilderError("k-mer length not set: call .k(<1..=32>) first")

        def _work() -> dict[str, int]:
            counts = api.count_kmers_with_quality(
                path, self._k.get(), self._input_format, self._min_quality
            )
            if self._min_count <= 1:
                return counts
            return {km: c for km, c in counts.items() if c >= self._min_count}

        return await asyncio.to_thread(_work)
