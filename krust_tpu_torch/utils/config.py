"""Runtime engine configuration.

Replaces the reference's compile-time cargo feature matrix
(reference: Cargo.toml:47-64) with one runtime dataclass: gzip/tracing
are always available; knobs that were features become fields here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch


def forced_platform() -> str | None:
    """The platform ``KRUST_PLATFORM`` asks for: None when it is unset or
    empty, ``"cpu"``, or ``"cuda"`` (spelled ``gpu`` or ``cuda``).

    The counterpart of krust_tpu's ``_cpu_platform_forced``.
    ``KRUST_PLATFORM=cpu`` runs the batch engine and the sharded path on
    the CPU, the kernels' plain versions; ``cuda`` raises ``RuntimeError``
    when no CUDA device is available; any other value raises
    ``ValueError``. ``JAX_PLATFORMS`` is JAX's own and is not read.
    """
    value = os.environ.get("KRUST_PLATFORM", "").strip().lower()
    if not value:
        return None
    if value == "cpu":
        return "cpu"
    if value in ("gpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"KRUST_PLATFORM={value}: no CUDA device is available")
        return "cuda"
    raise ValueError(f"KRUST_PLATFORM={value!r}: expected 'cpu', 'gpu' or 'cuda'")


def default_device() -> torch.device:
    """The CPU when ``KRUST_PLATFORM=cpu`` asks for it, else the first
    CUDA device when one is visible, else the CPU."""
    if forced_platform() == "cpu":
        return torch.device("cpu")
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

    #: take the flat route (K1 on 2-bit stream slices plus sparse invalid
    #: positions) where the stream allows it; False sends every batch
    #: down the dense route (K4 on haloed 2-bit rows plus an invalid
    #: bitmask). Both give the same table.
    use_flat: bool = True

    #: device the batch engine counts on (None = :func:`default_device`)
    device: torch.device | str | None = None

    def resolved_device(self) -> torch.device:
        return torch.device(self.device) if self.device is not None else default_device()
