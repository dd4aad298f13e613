"""Counting engines.

Three interchangeable engines produce identical results:

- :class:`BatchEngine` — the GPU path. 2-bit stream slices (or, for
  dirty streams, dense 2-bit rows with an invalid bitmask) transfer in
  fixed-shape batches; a codec kernel (:mod:`krust_tpu_torch.ops.
  fused_codec`, :mod:`krust_tpu_torch.ops.codec`) turns each into raw
  sentinel-keyed window keys for the epoch-sort table
  (:class:`krust_tpu_torch.ops.table.EpochTable`: one flat ``torch.sort``
  per epoch + the RLE kernel, parts merged by the merge kernel). Replaces
  the reference's rayon + dashmap engine (reference: src/run.rs:489-583).
- :class:`NumpyEngine` / :class:`NativeEngine` — the same algorithm on the
  host in numpy uint64 / the native C++ core. The no-GPU engines, and the
  differential oracles.
- :class:`SequentialEngine` — record-at-a-time counting (numpy per record),
  mirroring the reference's single-threaded paths
  (reference: src/streaming.rs:665-830).

All engines consume :class:`~krust_tpu_torch.io.reader.ParsedStreams` and
return :class:`PackedCounts`.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..histogram import CountHistogram
from ..io.reader import ParsedStreams
from ..kmer import INVALID_CODE, unpack_many
from ..utils.config import EngineConfig, forced_platform
from ..utils.progress import Progress, ProgressTracker
from ..utils.tracing import span, trace_event

ProgressCallback = Callable[[Progress], None]


@dataclass
class PackedCounts:
    """Final counting result: sorted distinct canonical codes and counts.

    ``codes``/``counts`` are uint64 numpy arrays sorted by code. Counts use
    u64 accumulation; saturation at u64::MAX matches the reference contract
    (reference: src/run.rs:569) though it is unreachable for physical inputs.
    ``histogram`` is the count-of-counts of ``counts`` where the device took
    it: set only on a result that is one pulled table (one table lifetime).
    """

    k: int
    codes: np.ndarray
    counts: np.ndarray
    histogram: CountHistogram | None = field(default=None, compare=False, repr=False)

    @property
    def distinct(self) -> int:
        return int(self.codes.shape[0])

    @property
    def total(self) -> int:
        return int(self.counts.sum())

    def to_packed_dict(self) -> dict[int, int]:
        return dict(zip(self.codes.tolist(), self.counts.tolist()))

    def to_string_dict(self) -> dict[str, int]:
        strings = unpack_many(self.codes, self.k)
        return dict(zip(strings, self.counts.tolist()))

    def get(self, packed: int) -> int:
        i = np.searchsorted(self.codes, np.uint64(packed))
        if i < self.codes.shape[0] and self.codes[i] == np.uint64(packed):
            return int(self.counts[i])
        return 0

    @classmethod
    def empty(cls, k: int) -> "PackedCounts":
        return cls(k, np.zeros(0, np.uint64), np.zeros(0, np.uint64))


class _HostAccumulator:
    """Sums (codes, counts) partials, each sorted and distinct, into one
    such table: they wait until more than ``threshold`` entries are held,
    then :func:`_sum_tables` merges them (the sum counts towards the next
    threshold), and :meth:`result` merges what is left."""

    def __init__(self, threshold: int = 64_000_000):
        self._parts: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._threshold = threshold

    def add(self, codes: np.ndarray, counts: np.ndarray) -> None:
        if codes.shape[0] == 0:
            return
        self._parts.append((np.asarray(codes, np.uint64), np.asarray(counts, np.uint64)))
        self._pending += codes.shape[0]
        if self._pending > self._threshold:
            self._compact()

    def _compact(self) -> None:
        if self._parts:
            self._parts.append(_sum_tables(self._parts))
            self._pending = self._parts[0][0].shape[0]

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        self._compact()
        return self._parts[0] if self._parts else (np.zeros(0, np.uint64),
                                                    np.zeros(0, np.uint64))


def _merge_tables(a, b) -> tuple[np.ndarray, np.ndarray]:
    """The sum of two host tables, each (codes u64 ascending and distinct,
    counts u64), in the same form. Takes the tables' last references:
    ``a``'s counts take ``b``'s shared keys in place, and the codes are
    freed once the merged codes are written, so the peak is the inputs and
    one output array (a concatenation and its sort would hold three)."""
    a_codes, a_counts = a
    b_codes, b_counts = b
    del a, b
    na = a_codes.shape[0]
    pos = np.searchsorted(a_codes, b_codes)
    hit = pos < na
    hit[hit] = a_codes[pos[hit]] == b_codes[hit]
    a_counts[pos[hit]] += b_counts[hit]  # distinct keys: no index repeats
    new = ~hit
    dest = pos[new]  # where b's new keys land: before a[pos], after earlier new keys
    del pos, hit
    dest += np.arange(dest.shape[0])
    keep = np.ones(na + dest.shape[0], bool)  # the output slots a fills, in order
    keep[dest] = False
    codes = np.empty(keep.shape[0], np.uint64)
    codes[dest] = b_codes[new]
    codes[keep] = a_codes
    del a_codes, b_codes
    counts = np.empty(keep.shape[0], np.uint64)
    counts[dest] = b_counts[new]
    counts[keep] = a_counts
    return codes, counts


def _sum_tables(tables: list) -> tuple[np.ndarray, np.ndarray]:
    """The sum of host tables (each sorted and distinct) by
    :func:`_merge_tables`, a level of pairs at a time, so n tables of N
    entries cost O(N log n); empties ``tables``, each leaving the list as
    its merge takes it."""
    while len(tables) > 1:
        level = []
        while len(tables) > 1:
            level.append(_merge_tables(tables.pop(0), tables.pop(0)))
        tables[:] = level + tables
    return tables.pop()


def _quality_threshold(min_quality: int | None) -> int | None:
    """Phred threshold -> ASCII threshold, saturating (reference: src/run.rs:538)."""
    if min_quality is None:
        return None
    return min(min_quality + 33, 255)


class _ProgressPacer:
    """Apportions stream-level progress across device batches.

    The reference fires its callback after every sequence from worker
    threads (reference: src/run.rs:586-654); the device engine's unit of
    work is a window batch, so the callback fires once per batch with
    record/base totals apportioned by window fraction, then trued up to the
    exact totals when the stream is done. Same Progress payload, monotonic,
    batch cadence.
    """

    def __init__(
        self,
        tracker: ProgressTracker | None,
        callback: ProgressCallback | None,
        n_records: int,
        n_bases: int,
        total_windows: int,
    ):
        self._tracker = tracker
        self._callback = callback
        self._n_records = n_records
        self._n_bases = n_bases
        self._total = max(total_windows, 1)
        self._done_windows = 0
        self._rec_sent = 0
        self._base_sent = 0

    def step(self, windows: int) -> None:
        """Record one processed batch covering ``windows`` real windows."""
        if self._tracker is None:
            return
        self._done_windows = min(self._done_windows + windows, self._total)
        frac = self._done_windows / self._total
        rec = min(int(frac * self._n_records), self._n_records)
        base = min(int(frac * self._n_bases), self._n_bases)
        self._tracker.record_batch(rec - self._rec_sent, base - self._base_sent)
        self._rec_sent, self._base_sent = rec, base
        if self._callback is not None:
            self._callback(self._tracker.snapshot())

    def finish(self) -> None:
        """True up to the exact stream totals (always fires once)."""
        if self._tracker is None:
            return
        self._tracker.record_batch(
            self._n_records - self._rec_sent, self._n_bases - self._base_sent
        )
        self._rec_sent = self._n_records
        self._base_sent = self._n_bases
        if self._callback is not None:
            self._callback(self._tracker.snapshot())


# --- numpy host engine -----------------------------------------------------------


def count_stream_numpy(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Rolling canonical encode + count on host in uint64.

    Same semantics as the device codec (see ops/codec.py docstring); numpy
    has native 64-bit lanes so no hi/lo split is needed.
    """
    t = codes.shape[0] - k + 1
    if t <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    good = codes < INVALID_CODE
    if qual is not None and quality_threshold is not None:
        good = good & (qual >= quality_threshold)
    b = np.where(good, codes, 0).astype(np.uint64)
    comp = np.where(good, 3 - codes.astype(np.int64), 0).astype(np.uint64)

    fwd = np.zeros(t, np.uint64)
    rc = np.zeros(t, np.uint64)
    valid = np.ones(t, bool)
    for j in range(k):
        fwd = (fwd << np.uint64(2)) | b[j : j + t]
        rc = (rc << np.uint64(2)) | comp[k - 1 - j : k - 1 - j + t]
        valid &= good[j : j + t]
    canon = np.minimum(fwd, rc)
    return np.unique(canon[valid], return_counts=True)


def count_stream_host(
    codes: np.ndarray,
    qual: np.ndarray | None,
    k: int,
    quality_threshold: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Best host path: native C++ rolling+sort core, numpy fallback.

    The native core (io/native/krust_native.cpp krust_count_stream) is the
    sort-based host twin of the device engine — ~50x the pure-numpy path on a
    single core — used when no accelerator is available.
    """
    from ..io import native as _native

    res = _native.count_stream_native(codes, qual, quality_threshold, k)
    if res is not None:
        return res
    return count_stream_numpy(codes, qual, k, quality_threshold)


class NumpyEngine:
    """Pure-host engine; exact, no accelerator required.

    Stays pure numpy on purpose: it is the mid-level oracle of the 3-way
    differential (device / numpy / brute-force, SURVEY.md §4). The fast
    host path for production fallback is :class:`NativeEngine`.
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def count(
        self,
        streams: ParsedStreams,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        with span("process_sequences", engine="numpy", k=k):
            uniq, cnt = count_stream_numpy(streams.codes, streams.qual, k, thr)
        if tracker is not None:
            tracker.record_batch(streams.n_records, streams.n_bases)
            if progress is not None:
                progress(tracker.snapshot())
        counts = cnt.astype(np.uint64)
        return PackedCounts(k, uniq, counts)


class NativeEngine:
    """Host engine on the native C++ counting core (numpy fallback).

    The no-accelerator production engine: rolling canonical encode + sort +
    RLE in one native call — the same sort-based design as the device
    engine, not the reference's hash map (reference: src/run.rs:489-583).
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def count(
        self,
        streams: ParsedStreams,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        with span("process_sequences", engine="native", k=k):
            uniq, cnt = count_stream_host(streams.codes, streams.qual, k, thr)
        if tracker is not None:
            tracker.record_batch(streams.n_records, streams.n_bases)
            if progress is not None:
                progress(tracker.snapshot())
        return PackedCounts(k, uniq, np.asarray(cnt, dtype=np.uint64))


# --- device batch engine ----------------------------------------------------------


class _Feed:
    """Stage ``gen``'s batches on a background thread, ``depth`` deep.

    The double-buffered host->device feed: ``stage_fn`` (host glue, pinned
    copy, non-blocking transfer) runs off the main thread so transfers
    overlap the device work the main loop keeps enqueueing. A bounded queue
    caps in-flight batches; FIFO order keeps results bit-identical to the
    synchronous loop. ``depth <= 0`` is the synchronous map.

    Three spans: ``feed_pack`` around each ``next()`` of ``gen`` (the
    dense route's row cuts, with its pack where no scan made it, or the
    flat path's slicing) and ``feed_stage`` around each
    ``stage_fn`` call, both on the ``krust-feed`` thread (on the consumer's
    thread when ``depth <= 0``); ``feed_wait`` around the consumer's wait
    for a staged batch, on the consumer's thread, opened only when
    ``depth > 0``.

    A context manager: leaving the ``with`` block — normally, or by an
    exception in the consumer's loop — stops the worker, drops staged
    batches and joins the thread, so no feeder outlives its consumer.
    """

    def __init__(self, gen, stage_fn, depth: int):
        self._gen = gen
        self._stage = stage_fn
        self._depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._err: list[BaseException] = []
        self._done = object()
        self._thread: threading.Thread | None = None

    def __enter__(self) -> "_Feed":
        if self._depth > 0:
            self._thread = threading.Thread(
                target=self._work, name="krust-feed", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                self._drain()  # unblocks a put; frees staged device buffers
                self._thread.join(0.05)
            self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _packed(self):
        """``gen``'s batches, each ``next()`` one ``feed_pack`` span."""
        it = iter(self._gen)
        while True:
            with span("feed_pack"):
                b = next(it, self._done)
            if b is self._done:
                return
            yield b

    def _staged(self, b):
        with span("feed_stage"):
            return self._stage(b)

    def _work(self) -> None:
        try:
            for b in self._packed():
                if self._stop.is_set() or not self._put(self._staged(b)):
                    return
        except BaseException as e:  # re-raised in the consumer
            self._err.append(e)
        finally:
            self._put(self._done)

    def __iter__(self):
        if self._thread is None:
            for b in self._packed():
                yield self._staged(b)
            return
        while True:
            with span("feed_wait"):
                item = self._q.get()
            if item is self._done:
                if self._err:
                    raise self._err[0]
                return
            yield item


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> ``device``: through a pinned buffer and a
    non-blocking copy for CUDA (ordered on the current stream)."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Lifetimes:
    """A count's table (one device's, or a sharded count's slots) and the
    host tables pulled from it: the one owner of the rule that a table
    lifetime, its counts int32, holds fewer than ``EPOCH_WINDOW_LIMIT``
    windows. The rule is checked at each group's first batch, a group
    being a batch on each of the table's ``devices``, so every rank of a
    process group pulls (a collective there) at the same batch. A batch
    charges ``charge`` windows (None: its own); the LSM table
    (``weighted``) takes weights beside its keys, None, one a window."""

    def __init__(self, table, weighted: bool, charge: int | None = None):
        self.table = table
        self.devices = getattr(table, "devices", None) or (table._device,)
        self._weights = (None,) if weighted else ()
        self._charge = charge
        self._windows = 0  # charged to the lifetime the table holds
        self.batches = 0  # charged to the count
        self._pulled: list = []

    def charge(self, windows: int = 0) -> int:
        """Charge the next batch (added next, or one this rank lacks) and
        return its windows; first pull the table if the batch opens a
        group that could reach the limit."""
        from ..ops import table as table_mod

        windows = self._charge or windows
        slots = len(self.devices)
        if self.batches % slots == 0 and (
            self._windows + slots * windows >= table_mod.EPOCH_WINDOW_LIMIT
        ):
            self._pulled.append(self.table.finalize())  # int32 count headroom
            self._windows = 0
        self._windows += windows
        self.batches += 1
        return windows

    def add(self, keys: torch.Tensor, windows: int) -> None:
        """Add a charged batch's window keys to the table."""
        self.table.add(keys, *self._weights, windows)

    def result(self, k: int) -> PackedCounts:
        """Pull the last lifetime and sum the lifetimes' host tables with
        :func:`_sum_tables`. One pulled table keeps the histogram the
        device took of it; a sum of several has none."""
        pulled = self._pulled
        pulled.append(self.table.finalize())
        histogram = pulled[0].histogram if len(pulled) == 1 else None
        if len(pulled) > 1:
            with span("merge_lifetimes", lifetimes=len(pulled)):
                pulled.append(_sum_tables(pulled))
        codes64, counts64 = pulled.pop()
        trace_event("unpack_kmers", unique_kmers=int(codes64.shape[0]))
        return PackedCounts(k, codes64, counts64, histogram)


class BatchEngine:
    """Device engine: stream fixed-shape batches through the codec kernel
    into the count table (epoch-sort, or the LSM table when
    ``config.use_epoch_sort`` is False), on ``config.device``."""

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.device = self.config.resolved_device()

    def _make_table(self, k: int):
        from ..ops.table import DeviceTable, EpochTable

        table = EpochTable if self.config.use_epoch_sort else DeviceTable
        return table(k, device=self.device)

    def _feed_streams(
        self, streams, k, min_quality, lifetimes: _Lifetimes, on_windows,
        batch_span="encode_count_batch",
    ) -> None:
        """Feed one parsed stream's batches into ``lifetimes``' table (shared
        by the eager and chunked ingest paths and the sharded count).

        The flat path while invalid bases are sparse (K1 on stream slices
        plus invalid positions); the dense path (K4 on haloed 2-bit rows
        plus an invalid bitmask) for dirtier streams, for block geometries
        the flat layout cannot hold and under ``use_flat=False``, as
        ``krust_tpu`` routes.
        Batch i is staged on ``devices[i % n]``, the table's devices, each
        device's copies on its own current stream, and the table takes the
        batches in that order; ``lifetimes`` charges each batch before its
        add. Each batch's encode and add is one ``batch_span``; the route
        scan one ``flat_scan`` (fields ``route``, ``invalid``, ``threads``).
        """
        from ..io.packer import pack_buffer_2bit, route_batches
        from ..ops.codec import encode_dense
        from ..ops.fused_codec import TAIL_BYTES, encode_windows

        cfg = self.config
        devices = lifetimes.devices
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        qual_stream = streams.qual if thr is not None else None
        streams_of = {d: torch.cuda.current_stream(d) for d in devices if d.type == "cuda"}
        staged_on = itertools.cycle(devices)  # stage runs in batch order

        def to_device(*arrays):
            dev = next(staged_on)
            if dev not in streams_of:
                return tuple(_to_device(a, dev) for a in arrays)
            with torch.cuda.stream(streams_of[dev]):
                return tuple(_to_device(a, dev) for a in arrays)

        if cfg.use_flat:
            # the route scan, here on the host's cores: the flat route's 2-bit
            # bytes and invalid positions, or the dense route's 2-bit bytes and
            # invalid mask, which the feed then only cuts into rows
            with span("flat_scan") as fields:
                scan, batches = route_batches(
                    streams.codes, qual_stream, k, thr, cfg.block_windows, cfg.batch_rows
                )
                fields.update(route=scan.route, invalid=scan.n_invalid, threads=scan.threads)
            flat = scan.route == "flat"
        else:
            batches = pack_buffer_2bit(
                streams.codes, qual_stream, k, thr, cfg.block_windows, cfg.batch_rows
            )
            flat = False
        if flat:

            def stage(b):
                need = b.rows * b.block_windows // 4 + TAIL_BYTES
                packed = np.zeros(need, np.uint8)
                m = min(need, b.packed2.shape[0])
                packed[:m] = b.packed2[:m]
                return to_device(packed, b.invpos), b

            def step(arrays, b):
                # packed slice + invalid positions -> one poisoned key per window
                return encode_windows(*arrays, b.covered, k, b.rows * b.block_windows)

            def rows_and_windows(b):
                return b.rows, b.covered
        else:  # dense: too many invalid bases, or a geometry flat cannot hold

            def stage(b):  # padding rows are all-bad (0xFF badbits)
                return to_device(b.packed2, b.badbits), b

            def step(arrays, b):
                # haloed 2-bit rows + invalid bitmask -> one poisoned key per window
                return encode_dense(*arrays, k, b.block_windows)

            def rows_and_windows(b):
                return b.packed2.shape[0], b.n_windows

        with _Feed(batches, stage, cfg.feed_depth) as staged:
            for arrays, batch in staged:
                rows, windows = rows_and_windows(batch)
                charged = lifetimes.charge(rows * batch.block_windows)
                with span(batch_span, rows=rows):
                    lifetimes.add(step(arrays, batch), charged)
                on_windows(windows)

    def count(
        self,
        streams: ParsedStreams,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        lifetimes = _Lifetimes(self._make_table(k), not self.config.use_epoch_sort)
        total_windows = max(streams.codes.shape[0] - k + 1, 0)
        pacer = _ProgressPacer(
            tracker, progress, streams.n_records, streams.n_bases, total_windows
        )
        self._feed_streams(streams, k, min_quality, lifetimes, pacer.step)
        pacer.finish()
        return lifetimes.result(k)

    def count_chunked(
        self,
        chunks,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        """Count an iterator of :class:`ParsedStreams` chunks as one input.

        The bounded-host-memory ingest path (reference's true-streaming
        engines: src/streaming.rs:513-616): each chunk is parsed, fed, and
        released before the next is read, so host RSS stays at
        O(chunk + device tables) regardless of input size. Exact: chunks cut
        at record boundaries, and the table accumulates across chunks.
        """
        lifetimes = _Lifetimes(self._make_table(k), not self.config.use_epoch_sort)
        for streams in chunks:
            self._feed_streams(streams, k, min_quality, lifetimes, lambda w: None)
            if tracker is not None:
                tracker.record_batch(streams.n_records, streams.n_bases)
                if progress is not None:
                    progress(tracker.snapshot())
        return lifetimes.result(k)

# --- sequential engine -------------------------------------------------------------


class SequentialEngine:
    """Record-at-a-time engine (reference: src/streaming.rs:665-830).

    Processes each record independently and merges — useful for bounded-memory
    pipes and as a third differential implementation.
    """

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()

    def count_records(
        self,
        records,
        k: int,
        min_quality: int | None = None,
        progress: ProgressCallback | None = None,
        tracker: ProgressTracker | None = None,
    ) -> PackedCounts:
        from ..kmer import BASE_LUT

        acc = _HostAccumulator()
        for rec in records:
            seq = rec.seq if hasattr(rec, "seq") else rec
            qual = rec.qual if hasattr(rec, "qual") else None
            codes = BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]
            qarr = (
                np.frombuffer(qual, dtype=np.uint8) if qual is not None else None
            )
            thr = _quality_threshold(min_quality) if qarr is not None else None
            uniq, cnt = count_stream_numpy(codes, qarr, k, thr)
            acc.add(uniq, np.asarray(cnt, dtype=np.uint64))
            if tracker is not None:
                tracker.record_sequence(len(seq))
                if progress is not None:
                    progress(tracker.snapshot())
        codes64, counts64 = acc.result()
        return PackedCounts(k, codes64, counts64)

# --- engine selection ---------------------------------------------------------------


def select_engine(cfg: EngineConfig):
    """The best available engine for this config and machine.

    Dispatch order: explicit numpy request (config beats environment —
    it is the documented differential-testing knob) -> KRUST_ENGINE env
    override (``native`` / ``numpy`` / ``device``; a forced device with no
    CUDA device, no explicit ``config.device`` and no ``KRUST_PLATFORM=cpu``
    raises) -> a CUDA device, an explicit ``config.device`` or
    ``KRUST_PLATFORM=cpu`` (:func:`~krust_tpu_torch.utils.config.forced_platform`:
    the batch engine on the CPU, as krust_tpu keeps its device engine on
    XLA-CPU when the CPU platform is forced) -> the batch engine; otherwise
    the native host core (numpy when it cannot build).
    """
    if cfg.use_numpy_backend:
        return NumpyEngine(cfg)  # explicit request: the pure-numpy oracle
    forced = os.environ.get("KRUST_ENGINE", "").lower()
    if forced == "numpy":
        return NumpyEngine(cfg)
    if forced == "native":
        return NativeEngine(cfg)
    device_ok = (cfg.device is not None or forced_platform() == "cpu"
                 or torch.cuda.is_available())
    if forced in ("device", "torch", "batch"):
        if not device_ok:
            raise RuntimeError(
                "KRUST_ENGINE=device requested but no CUDA device is available"
            )
        return BatchEngine(cfg)
    if forced:
        raise ValueError(
            f"KRUST_ENGINE={forced!r}: expected 'native', 'numpy' or 'device'"
        )
    if device_ok:
        return BatchEngine(cfg)
    return NativeEngine(cfg) if cfg.use_native_host else NumpyEngine(cfg)

def count_streams(
    streams: ParsedStreams,
    k: int,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
    progress: ProgressCallback | None = None,
    tracker: ProgressTracker | None = None,
) -> PackedCounts:
    """Count with the best available engine (see :func:`select_engine`)."""
    cfg = config or EngineConfig()
    engine = select_engine(cfg)
    return engine.count(streams, k, min_quality, progress, tracker)


def count_chunked_streams(
    chunks,
    k: int,
    min_quality: int | None = None,
    config: EngineConfig | None = None,
    progress: ProgressCallback | None = None,
    tracker: ProgressTracker | None = None,
) -> PackedCounts:
    """Count an iterator of :class:`ParsedStreams` chunks as one input.

    The bounded-host-memory twin of :func:`count_streams` (reference's
    true-streaming engines: src/streaming.rs:513-616): chunks are consumed
    and released one at a time on whichever engine is available, so host RSS
    stays at O(chunk + tables) for arbitrarily large pipes.
    """
    cfg = config or EngineConfig()
    engine = select_engine(cfg)
    if isinstance(engine, BatchEngine):
        return engine.count_chunked(chunks, k, min_quality, progress, tracker)
    count_fn = (
        count_stream_host
        if isinstance(engine, NativeEngine)
        else count_stream_numpy
    )
    acc = _HostAccumulator(cfg.host_compact_threshold)
    for streams in chunks:
        thr = _quality_threshold(min_quality) if streams.qual is not None else None
        uniq, cnt = count_fn(streams.codes, streams.qual, k, thr)
        acc.add(uniq, np.asarray(cnt, dtype=np.uint64))
        if tracker is not None:
            tracker.record_batch(streams.n_records, streams.n_bases)
            if progress is not None:
                progress(tracker.snapshot())
    codes64, counts64 = acc.result()
    return PackedCounts(k, codes64, counts64)
