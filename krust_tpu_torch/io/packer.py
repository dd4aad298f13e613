"""Host packer: flat code streams -> 2-bit batches for the device.

Given the flat separator-delimited code stream from the reader, this module
cuts it into batches of ``rows`` block rows of ``W`` windows each (a row's
``k - 1``-base halo is the next row's start, so every length-k window of the
stream lands in exactly one row). Two layouts cross to the device:

- flat (:func:`flat_batches`): a batch is a contiguous 2-bit slice of the
  stream plus the sorted positions of its invalid bases, taken while
  invalid bases are at most 1/32 of the stream;
- dense (:func:`pack_buffer_2bit`): each row is its own haloed 2-bit row
  plus a 1-bit-per-base invalid mask, for dirtier streams and for block
  geometries the flat layout cannot hold.

The codec kernels key every window and give a window holding an invalid
base, or one past the stream's end, the sentinel key — the device analog
of the reference's per-record window scan restarting after an invalid base
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
class PackedBatch2:
    """Bit-packed dense device batch: 2-bit base codes + 1-bit invalid mask.

    0.375 bytes/base on the link: ``packed2`` holds 4 bases/byte (first
    base in the high 2 bits), ``badbits`` 8 validity flags/byte (bit 7 =
    first base; set = invalid). Quality filtering is folded into
    ``badbits`` on the host, so no quality bytes cross the link. Padding
    rows are all-bad; bases past the stream's end are bad, so no window
    needs a ``covered`` mask.
    """

    packed2: np.ndarray  # [B, ceil(width/4)] uint8
    badbits: np.ndarray  # [B, ceil(width/8)] uint8
    n_windows: int
    block_windows: int
    width: int  # unpacked row width = block_windows + k - 1


def pack_stream_2bit(
    codes: np.ndarray,
    qual: np.ndarray | None = None,
    quality_threshold: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack a flat code stream into (packed2, badbits) arrays (host, numpy)."""
    n = codes.shape[0]
    bad = codes >= INVALID_CODE
    if qual is not None and quality_threshold is not None:
        bad = bad | (qual < quality_threshold)
    b2 = codes & 3

    n4 = -(-max(n, 1) // 4) * 4
    if n4 != n:
        b2 = np.concatenate([b2, np.zeros(n4 - n, np.uint8)])
    q = b2.reshape(-1, 4).astype(np.uint8)
    packed2 = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]

    n8 = -(-max(n, 1) // 8) * 8
    if n8 != n:
        bad = np.concatenate([bad, np.ones(n8 - n, bool)])
    badbits = np.packbits(bad)
    return packed2, badbits


def pack_buffer_2bit(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
    block_windows: int = DEFAULT_BLOCK_WINDOWS,
    batch_rows: int | None = None,
    row_multiple: int = ROW_MULTIPLE,
):
    """Yield :class:`PackedBatch2` chunks covering the whole stream.

    ``block_windows`` must be a multiple of 8 so every row starts on both a
    4-base (packed2) and 8-base (badbits) boundary; other geometries raise.
    """
    w = block_windows
    if w % 8:
        raise ValueError(f"block_windows must be a multiple of 8, got {w}")
    width = w + k - 1
    t = max(codes.shape[0] - k + 1, 0)
    n_blocks = -(-t // w) if t > 0 else 0

    packed2, badbits = pack_stream_2bit(codes, qual, quality_threshold)
    p4 = -(-width // 4)
    p8 = -(-width // 8)

    # pad packed streams so the last row's slices stay in bounds
    need4 = (max(n_blocks, 1) - 1) * (w // 4) + p4
    if packed2.shape[0] < need4:
        packed2 = np.concatenate(
            [packed2, np.zeros(need4 - packed2.shape[0], np.uint8)]
        )
    need8 = (max(n_blocks, 1) - 1) * (w // 8) + p8
    if badbits.shape[0] < need8:
        badbits = np.concatenate(
            [badbits, np.full(need8 - badbits.shape[0], 0xFF, np.uint8)]
        )

    step_rows = batch_rows if batch_rows is not None else max(n_blocks, 1)
    for row0 in range(0, max(n_blocks, 1), step_rows):
        rows = min(step_rows, max(n_blocks, 1) - row0)
        rows_padded = max(-(-rows // row_multiple) * row_multiple, row_multiple)
        v4 = np.lib.stride_tricks.sliding_window_view(packed2, p4)[:: w // 4]
        v8 = np.lib.stride_tricks.sliding_window_view(badbits, p8)[:: w // 8]
        out4 = np.zeros((rows_padded, p4), np.uint8)
        out8 = np.full((rows_padded, p8), 0xFF, np.uint8)
        if n_blocks > 0:
            out4[:rows] = v4[row0 : row0 + rows]
            out8[:rows] = v8[row0 : row0 + rows]
        covered = min((row0 + rows) * w, t) - row0 * w if t > 0 else 0
        yield PackedBatch2(out4, out8, max(covered, 0), w, width)


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


def batch_count(n_bases: int, k: int, block_windows: int, batch_rows: int) -> int:
    """How many batches :func:`flat_batches` and :func:`pack_buffer_2bit`
    cut a stream of ``n_bases`` into: at least one, even for no window."""
    t = max(n_bases - k + 1, 0)
    n_blocks = -(-t // block_windows)
    return -(-max(n_blocks, 1) // batch_rows)


def _flat_eligible(k: int, w: int, batch_rows: int) -> bool:
    """Geometry preconditions of the flat path.

    Rows must start on byte boundaries (w % 8), the halo must fit one block,
    and segment offsets must fit int32. Other geometries take the dense
    path (:func:`pack_buffer_2bit`).
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
    """The flat path's stream scan: ``(packed2 | None, invpos)``, or None.

    The native scan packs 2-bit bytes and collects the invalid positions in
    one pass; without it, a numpy scan collects the positions and the 2-bit
    pack is left to the consumer (``packed2`` None). Returns None when the
    invalid positions exceed ``max_inv`` (the caller takes the dense path).
    """
    from . import native

    scanned = native.scan_stream_native(codes, qual, quality_threshold, max_inv)
    if scanned is not None:
        packed2_pre, inv, n_inv = scanned
        if n_inv > max_inv:
            return None
        return packed2_pre, inv
    inv = invalid_positions(codes, qual, quality_threshold)
    if inv.shape[0] > max_inv:
        return None
    return None, inv


def flat_batches(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
    block_windows: int = DEFAULT_BLOCK_WINDOWS,
    batch_rows: int = 8192,
    row_multiple: int = ROW_MULTIPLE,
    prescanned: tuple[np.ndarray | None, np.ndarray] | None = None,
):
    """Yield :class:`FlatBatch` chunks, or None for the dense path.

    Returns None when the geometry is ineligible (see
    :func:`_flat_eligible`) or when invalid bases exceed 1/32 of the
    stream: past that point the positions array outweighs a dense bitmask.
    ``prescanned`` takes a caller's own :func:`flat_scan` result in place
    of the scan at ``max_inv = n // 32``.
    """
    w = block_windows
    if not _flat_eligible(k, w, batch_rows):
        return None
    n = codes.shape[0]
    scan = (
        prescanned
        if prescanned is not None
        else flat_scan(codes, qual, quality_threshold, n // 32)
    )
    if scan is None:
        return None
    packed2_pre, inv = scan

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
