"""Roofline arithmetic of the kernels' roles, from the sizes of the
problem (bases, windows counted, distinct entries), never from the
launches or padding of the kernels that do the work.

Peaks: NVIDIA's H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of
HBM, and 67 T/s of float32 outside the tensor cores taken as the rate of
the kernels' integer work (chip_smoke.py's ``_bound``). The bound is the
larger of bytes over the one and operations over the other; bytes bound
both roles below (their operations take a third of the time or less).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def codec_bytes(bases: int, windows: int) -> float:
    """The codec reads the input's 2-bit form and writes one int64 key for
    each window that is counted."""
    return bases / 4 + 8 * windows


def codec_ops(windows: int, k: int) -> float:
    """Per counted window: one forward code step, a reverse complement of
    the k base pairs, a minimum, and a validity test over k flags
    (chip_smoke.py's ``_codec_ops``)."""
    return windows * (2 * k + 10)


def rle_bytes(raw_keys: int, distinct: int) -> float:
    """Run-length compaction reads each sorted raw int64 key once and
    writes each distinct entry once: its int64 key and int32 count."""
    return 8 * raw_keys + 12 * distinct


def rle_ops(raw_keys: int) -> float:
    """One compare with the neighbour and one select per raw key."""
    return 2 * raw_keys


def share_pct(n_bytes: float, seconds: float, n_ops: float = 0.0) -> float | None:
    """Share of the bound (the larger of bytes over the memory rate and
    operations over the ALU rate) in the device time the kernels took;
    None where they took none."""
    if seconds <= 0:
        return None
    return 100.0 * max(n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S) / seconds
