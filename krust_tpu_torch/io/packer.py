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

:func:`route_batches` picks the route: the native scan of the stream on
the host's cores (:func:`scan_stream`) counts its invalid bases and writes
the chosen layout's whole-stream arrays: the flat route's 2-bit bytes and
invalid positions, or the dense route's 2-bit bytes and invalid mask, from
which :func:`pack_buffer_2bit` only cuts rows.

The codec kernels key every window and give a window holding an invalid
base, or one past the stream's end, the sentinel key — the device analog
of the reference's per-record window scan restarting after an invalid base
(reference: src/run.rs:526-563, src/streaming.rs:622-660).
"""

from __future__ import annotations

import threading
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np

from ..kmer import INVALID_CODE
from ..utils.numutil import round_pow2

#: Windows per block row (a multiple of 8, so rows start on byte boundaries).
DEFAULT_BLOCK_WINDOWS = 4096

#: Row-count multiple for padding.
ROW_MULTIPLE = 8

#: whole-stream dense packs in the process (a stream's 2-bit bytes and
#: invalid mask for :func:`pack_buffer_2bit`'s rows, made by the route scan
#: or by the packer), counted as ``EpochTable.flushes`` counts flushes
dense_packs = 0
_DENSE_PACKS_LOCK = threading.Lock()


def _count_dense_pack() -> None:
    global dense_packs
    with _DENSE_PACKS_LOCK:  # the scan's thread and the feed's both pack
        dense_packs += 1


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


def _dense_lengths(n: int, k: int, block_windows: int) -> tuple[int, int]:
    """Bytes of the whole-stream packed2 and badbits that the last of
    :func:`pack_buffer_2bit`'s rows reaches (its halo included)."""
    w = block_windows
    width = w + k - 1
    t = max(n - k + 1, 0)
    last = max(-(-t // w), 1) - 1
    return last * (w // 4) + -(-width // 4), last * (w // 8) + -(-width // 8)


def _pack_dense(codes, qual, quality_threshold, need4: int, need8: int):
    """The whole stream's (packed2, badbits), padded to ``need4`` and
    ``need8`` bytes: one native pass on the host's cores, numpy without
    the native library."""
    from . import native

    _count_dense_pack()
    packed = native.scan_pack_native(codes, qual, quality_threshold, -1, need4, need8)
    if packed is not None:
        return packed[0], packed[2]
    packed2, badbits = pack_stream_2bit(codes, qual, quality_threshold)
    if packed2.shape[0] < need4:
        packed2 = np.concatenate([packed2, np.zeros(need4 - packed2.shape[0], np.uint8)])
    if badbits.shape[0] < need8:
        badbits = np.concatenate([badbits, np.full(need8 - badbits.shape[0], 0xFF, np.uint8)])
    return packed2, badbits


def pack_buffer_2bit(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
    block_windows: int = DEFAULT_BLOCK_WINDOWS,
    batch_rows: int | None = None,
    row_multiple: int = ROW_MULTIPLE,
    prepacked: tuple[np.ndarray, np.ndarray] | None = None,
):
    """Yield :class:`PackedBatch2` chunks covering the whole stream.

    ``block_windows`` must be a multiple of 8 so every row starts on both a
    4-base (packed2) and 8-base (badbits) boundary; other geometries raise.
    ``prepacked`` takes the whole stream's ``(packed2, badbits)`` from a
    dense :func:`scan_stream` at the same ``k`` and ``block_windows``
    (``StreamScan.prepacked``): the batches are then only cut from them.
    Without it the stream is packed here, on the first ``next()``.
    """
    w = block_windows
    if w % 8:
        raise ValueError(f"block_windows must be a multiple of 8, got {w}")
    width = w + k - 1
    t = max(codes.shape[0] - k + 1, 0)
    n_blocks = -(-t // w) if t > 0 else 0
    need4, need8 = _dense_lengths(codes.shape[0], k, w)

    if prepacked is None:
        packed2, badbits = _pack_dense(codes, qual, quality_threshold, need4, need8)
    else:
        packed2, badbits = prepacked
        if packed2.shape[0] < need4 or badbits.shape[0] < need8:
            raise ValueError("prepacked arrays are shorter than the rows they cut")
    p4 = -(-width // 4)
    p8 = -(-width // 8)

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


@dataclass
class StreamScan:
    """The route scan of a whole stream (:func:`scan_stream`)."""

    route: str  # "flat": at most max_inv invalid bases; "dense"
    n_invalid: int  # invalid bases, exact
    threads: int  # the native scan's threads; 0: the numpy scan
    packed2: np.ndarray | None  # flat: ceil(n/4) 2-bit bytes (None: numpy); dense: padded
    invpos: np.ndarray | None  # flat: the invalid positions, int64, ascending
    badbits: np.ndarray | None  # dense: the invalid mask, padded

    @property
    def prepacked(self) -> tuple[np.ndarray, np.ndarray] | None:
        """:func:`pack_buffer_2bit`'s ``prepacked``: a dense scan's arrays."""
        return None if self.badbits is None else (self.packed2, self.badbits)


def scan_stream(
    codes: np.ndarray,
    qual: np.ndarray | None,
    quality_threshold: int | None,
    max_inv: int,
    k: int | None = None,
    block_windows: int = DEFAULT_BLOCK_WINDOWS,
) -> StreamScan:
    """Count the stream's invalid bases (non-ACGT, or below the quality
    threshold) on the host's cores; the route is flat when they are at most
    ``max_inv`` (``max_inv < 0``: always dense).

    A native counting pass decides the route; the pass that follows writes
    every base's 2-bit byte and the route's other array. Flat: ``packed2``
    and ``invpos``, byte-equal to the core's ``krust_scan_stream``. Dense,
    given ``k``: ``packed2`` and the invalid mask ``badbits``, padded to the
    rows :func:`pack_buffer_2bit` cuts at ``k`` and ``block_windows``
    (``max_inv < 0``: no counting pass). Without the native library a
    numpy scan collects the positions and leaves every pack to the
    consumer.
    """
    from . import native

    n = codes.shape[0]
    need4, need8 = _dense_lengths(n, k, block_windows) if k is not None else (0, 0)
    scanned = native.scan_pack_native(codes, qual, quality_threshold, max_inv, need4, need8)
    if scanned is None:
        inv = invalid_positions(codes, qual, quality_threshold)
        if inv.shape[0] <= max_inv:
            return StreamScan("flat", inv.shape[0], 0, None, inv, None)
        return StreamScan("dense", inv.shape[0], 0, None, None, None)
    packed2, inv, badbits, n_inv, threads = scanned
    if inv is not None:
        return StreamScan("flat", n_inv, threads, packed2[: -(-n // 4)], inv, None)
    if badbits is None:
        return StreamScan("dense", n_inv, threads, None, None, None)
    _count_dense_pack()
    return StreamScan("dense", n_inv, threads, packed2, None, badbits)


def _flat_budget(n: int) -> int:
    """The most invalid bases a stream of ``n`` bases takes the flat route
    with: past 1/32 of it the positions outweigh the dense bitmask."""
    return n // 32


def route_batches(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None,
    block_windows: int = DEFAULT_BLOCK_WINDOWS,
    batch_rows: int = 8192,
) -> tuple[StreamScan, Iterator[FlatBatch] | Iterator[PackedBatch2]]:
    """The route scan and the batches of the route it picks: ``(scan,
    batches)``, ``batches`` :func:`flat_batches`' when ``scan.route`` is
    "flat", else :func:`pack_buffer_2bit`'s.

    The route is flat when the geometry is eligible (:func:`_flat_eligible`)
    and the invalid bases are at most :func:`_flat_budget`'s; the scan then
    leaves the flat batches only to slice. Dense, it packs the whole stream
    for the rows, which the batches only cut.
    """
    w = block_windows
    eligible = _flat_eligible(k, w, batch_rows)
    max_inv = _flat_budget(codes.shape[0]) if eligible else -1
    scan = scan_stream(codes, qual, quality_threshold, max_inv, k, w)
    if scan.route == "flat":
        return scan, flat_batches(codes, qual, k, quality_threshold, w, batch_rows,
                                  prescanned=(scan.packed2, scan.invpos))
    return scan, pack_buffer_2bit(codes, qual, k, quality_threshold, w, batch_rows,
                                  prepacked=scan.prepacked)


def flat_scan(
    codes: np.ndarray,
    qual: np.ndarray | None,
    quality_threshold: int | None,
    max_inv: int,
):
    """The flat path's stream scan: ``(packed2 | None, invpos)``, or None.

    :func:`scan_stream`'s flat outputs (``packed2`` None after the numpy
    scan: the 2-bit pack is left to the consumer). Returns None when the
    invalid positions exceed ``max_inv`` (the caller takes the dense path).
    """
    scan = scan_stream(codes, qual, quality_threshold, max_inv)
    return (scan.packed2, scan.invpos) if scan.route == "flat" else None


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
    of the scan at :func:`_flat_budget`.
    """
    w = block_windows
    if not _flat_eligible(k, w, batch_rows):
        return None
    n = codes.shape[0]
    scan = (
        prescanned
        if prescanned is not None
        else flat_scan(codes, qual, quality_threshold, _flat_budget(n))
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
