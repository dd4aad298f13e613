"""Host packer: flat code streams -> 2-bit stream slices for the device.

Given the flat separator-delimited code stream from the reader, this module
cuts it into batches of ``rows`` block rows of ``W`` windows each (a row's
``k - 1``-base halo is the next row's start, so every length-k window of the
stream lands in exactly one row). A batch crosses to the device as its
2-bit packed bytes plus the sorted positions of its invalid bases; the codec
kernel keys every window and gives a window holding an invalid base, or one
past the stream's end, the sentinel key — the device analog of the
reference's per-record window scan restarting after an invalid base
(reference: src/run.rs:526-563, src/streaming.rs:622-660).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..kmer import INVALID_CODE
from ..utils.numutil import round_pow2

#: Windows per block row (a multiple of 8, so rows start on byte boundaries).
DEFAULT_BLOCK_WINDOWS = 4096

#: Row-count multiple for padding.
ROW_MULTIPLE = 8


@dataclass
class FlatBatch:
    """Flat-transfer device batch: a contiguous 2-bit slice of the stream.

    The minimal-byte host->device format (0.25 bytes/base + 4 bytes per
    *invalid* base): ``packed2`` is a zero-copy slice of the whole stream's
    2-bit packing covering rows ``[row0, row0 + rows)`` of the haloed block
    decomposition; ``invpos`` lists invalid base positions relative to the
    slice start (int32, padded with an out-of-range sentinel). The device
    unpacks, scatters INVALID at ``invpos``, builds the haloed [rows, width]
    block tensor with reshape/slice (no gathers), and masks windows at index
    >= ``covered``. Sparse invalid bases (the common case for real
    sequencing data) cost almost nothing; a dirty stream pays 4 bytes per
    invalid base on the link.
    """

    packed2: np.ndarray  # [ceil((rows*w + k - 1)/4)] uint8, 4 bases/byte
    invpos: np.ndarray  # [P] int32 invalid positions, sentinel-padded
    covered: int  # real windows in this batch (mask beyond)
    rows: int  # block rows (already bucket-padded)
    block_windows: int
    n_invalid: int  # real entries in invpos



def invalid_positions(
    codes: np.ndarray,
    qual: np.ndarray | None = None,
    quality_threshold: int | None = None,
) -> np.ndarray:
    """Positions of invalid (or quality-failing) bases in a flat stream.

    int64: streams can exceed 2^31 bases (a human genome at coverage is
    several Gbases). Per-batch offsets are rebased to int32 in
    :func:`flat_batches`, where segments are < 2^31 by construction.
    """
    bad = codes >= INVALID_CODE
    if qual is not None and quality_threshold is not None:
        bad = bad | (qual < quality_threshold)
    return np.flatnonzero(bad)


def pack2_full(codes: np.ndarray) -> np.ndarray:
    """2-bit pack a whole stream: 4 bases/byte, first base in the high bits.

    Invalid codes pack as (code & 3) garbage — callers carry their positions
    separately (:func:`invalid_positions`). Uses the native packer when
    available; exact numpy fallback otherwise.
    """
    from . import native

    packed = native.pack2_native(codes)
    if packed is not None:
        return packed
    n = codes.shape[0]
    if n == 0:
        return np.zeros(0, np.uint8)
    n4 = -(-n // 4) * 4
    b2 = codes & 3
    if n4 != n:
        b2 = np.concatenate([b2, np.zeros(n4 - n, np.uint8)])
    q = b2.reshape(-1, 4)
    return (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]


def _flat_eligible(k: int, w: int, batch_rows: int) -> bool:
    """Geometry preconditions of the flat path.

    Rows must start on byte boundaries (w % 8), the halo must fit one block,
    and segment offsets must fit int32. Other geometries need the dense
    path, which is not ported yet (ROADMAP A8).
    """
    return not (w % 8 or w < k - 1 or batch_rows * w + k - 1 >= (1 << 31))


def _flat_segments(n: int, k: int, w: int, batch_rows: int, row_multiple: int):
    """Per-batch geometry of the flat decomposition.

    Yields (row0, rows_padded, seg_bases, base0, covered) per batch.
    """
    t = max(n - k + 1, 0)
    n_blocks = -(-t // w) if t > 0 else 0
    for row0 in range(0, max(n_blocks, 1), batch_rows):
        rows = min(batch_rows, max(n_blocks, 1) - row0)
        rows_padded = max(-(-rows // row_multiple) * row_multiple, row_multiple)
        # bucket rows to a power of two above the row multiple so at most
        # log2(batch_rows) batch shapes ever occur
        rows_padded = min(round_pow2(rows_padded, row_multiple), batch_rows)
        seg_bases = rows_padded * w + k - 1
        base0 = row0 * w
        covered = min((row0 + rows) * w, t) - base0 if t > 0 else 0
        yield row0, rows_padded, seg_bases, base0, max(covered, 0)


def flat_scan(
    codes: np.ndarray,
    qual: np.ndarray | None,
    quality_threshold: int | None,
    max_inv: int,
):
    """The flat path's stream scan: ``(packed2 | None, invpos)``.

    The native scan packs 2-bit bytes and collects up to ``max_inv``
    invalid positions in one pass. Without it, or past ``max_inv`` (a dirty
    stream), a numpy scan sized to the positions' count collects them and
    the 2-bit pack is left to the consumer (``packed2`` None).
    """
    from . import native

    scanned = native.scan_stream_native(codes, qual, quality_threshold, max_inv)
    if scanned is not None and scanned[2] <= max_inv:
        return scanned[0], scanned[1]
    return None, invalid_positions(codes, qual, quality_threshold)


def flat_batches(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
    block_windows: int = DEFAULT_BLOCK_WINDOWS,
    batch_rows: int = 8192,
    row_multiple: int = ROW_MULTIPLE,
):
    """Yield :class:`FlatBatch` chunks, or None for an ineligible geometry.

    ``block_windows`` must be a multiple of 8 so every row starts on a
    4-base byte boundary (see :func:`_flat_eligible`). Any density of
    invalid bases is accepted.
    """
    w = block_windows
    if not _flat_eligible(k, w, batch_rows):
        return None
    n = codes.shape[0]
    packed2_pre, inv = flat_scan(codes, qual, quality_threshold, n // 32)

    def gen():
        packed2 = packed2_pre if packed2_pre is not None else pack2_full(codes)
        for _, rows_padded, seg_bases, base0, covered in _flat_segments(
            n, k, w, batch_rows, row_multiple
        ):
            seg_bytes = -(-seg_bases // 4)
            b0 = base0 // 4
            seg = packed2[b0 : b0 + seg_bytes]
            if seg.shape[0] < seg_bytes:  # tail: pad
                seg = np.concatenate(
                    [seg, np.zeros(seg_bytes - seg.shape[0], np.uint8)]
                )
            i0, i1 = np.searchsorted(inv, [base0, base0 + seg_bases])
            seg_inv = (inv[i0:i1] - base0).astype(np.int32)  # < 2^31 by seg size
            p = round_pow2(seg_inv.shape[0], 8)
            if p != seg_inv.shape[0]:
                seg_inv = np.concatenate(
                    [
                        seg_inv,
                        np.full(p - seg_inv.shape[0], seg_bases, np.int32),
                    ]
                )
            yield FlatBatch(seg, seg_inv, covered, rows_padded, w, i1 - i0)

    return gen()
