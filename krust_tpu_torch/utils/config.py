"""Runtime engine configuration.

Replaces the reference's compile-time cargo feature matrix
(reference: Cargo.toml:47-64) with one runtime dataclass: gzip/tracing
are always available; knobs that were features become fields here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def default_device() -> torch.device:
    """The first CUDA device when one is visible, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


@dataclass
class EngineConfig:
    """Tunables for the device counting pipeline."""

    #: windows per block row (a batch covers rows * block_windows windows)
    block_windows: int = 4096

    #: max rows per device batch; bounds the device footprint for huge
    #: inputs. 8192 rows x 4096 windows = 33.6M windows/batch.
    batch_rows: int = 8192

    #: host-side partial-results compaction threshold (entries)
    host_compact_threshold: int = 64_000_000

    #: force the numpy host backend (no torch device work) — used for
    #: differential testing
    use_numpy_backend: bool = False

    #: when no GPU is usable, count on the native C++ host core (rolling
    #: canonical + sort + RLE) instead of pure numpy; numpy remains the
    #: automatic fallback when the native lib can't build
    use_native_host: bool = True

    #: when set, file/stdin inputs stream through record-aligned chunks of
    #: this many bytes instead of one eager whole-file parse — bounded host
    #: memory for inputs larger than RAM (None = eager, the default)
    ingest_chunk_bytes: int | None = None

    #: double-buffered feed depth: a background thread stages (host glue +
    #: pinned host->device copy) up to this many batches ahead so transfers
    #: overlap device compute. 0 = synchronous feed. Results are
    #: bit-identical either way (FIFO order preserved).
    feed_depth: int = 2

    #: count through the epoch-sort table (raw keys, one flat sort + RLE per
    #: epoch, part merges by the merge kernel). False: the LSM
    #: :class:`~krust_tpu_torch.ops.table.DeviceTable` (weighted parts
    #: re-merged with the table by ``ops/count.merge_runs``), the on-device
    #: oracle of the epoch table and the base of the sharded tables.
    use_epoch_sort: bool = True

    #: device the batch engine counts on (None = :func:`default_device`)
    device: torch.device | str | None = None

    def resolved_device(self) -> torch.device:
        return torch.device(self.device) if self.device is not None else default_device()
