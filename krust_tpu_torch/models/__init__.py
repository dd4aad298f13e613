"""Counting engines (the pipeline "models"): device batch, streaming, sequential."""

from .engines import (
    PackedCounts,
    BatchEngine,
    NativeEngine,
    NumpyEngine,
    SequentialEngine,
    count_streams,
    select_engine,
)

__all__ = [
    "PackedCounts",
    "BatchEngine",
    "NativeEngine",
    "NumpyEngine",
    "SequentialEngine",
    "count_streams",
    "select_engine",
]
