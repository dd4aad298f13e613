"""The count tables: the port's counting core on the device.

Counterparts of ``krust_tpu/ops/table.py``'s two accumulators. Both take a
batch's sentinel-keyed window keys and give the distinct table back once,
in ``finalize``.

:class:`EpochTable` (the default, ``EngineConfig.use_epoch_sort``): batches
append RAW keys (no per-batch sort, no weights); once about
``epoch_entry_limit()`` entries are pending, one flat ``torch.sort`` plus
the RLE kernel (:mod:`krust_tpu_torch.ops.rle`) turn them into a compacted
distinct part. Parts merge pairwise with the merge kernel
(:mod:`krust_tpu_torch.ops.merge`) and re-compact.

:class:`DeviceTable` (``use_epoch_sort=False``): the LSM accumulator.
Batches append weighted parts (raw keys count 1 each); when ``max_parts``
parts or the pending-entry limit are reached, the parts and the compacted
table concatenate and re-merge with :func:`~krust_tpu_torch.ops.count.
merge_runs` (``torch.sort`` with the weights following, then the RLE
kernel). Every window is sorted once, the table once per compaction.

``_finish`` compacts either table to one device part; ``finalize`` pulls
that part's first n entries to the host, with the histogram of their
counts taken on the device (:mod:`krust_tpu_torch.ops.histogram`). The
pull moves the keys and the int32 counts in chunks through a small ring
of pinned host buffers, and the host's cores decode each chunk's keys to
u64 codes and widen its counts straight into the result arrays. The
sharded tables (:mod:`krust_tpu_torch.parallel.sharded`) are these tables
per rank, and exchange the finished part before the pull.

Kept from the TPU engine: the deferred n-sync (a sort's ``n_unique`` stays
on the device until the next flush or compaction needs it, so batches
queued since overlap the sort), the memory-scaled entry limits (their
values measured on the H100: see ``EPOCH_ENTRY_LIMIT``), and the one-shot
adaptive retune of the epoch size. Not kept: the pull encodings
for a tunnelled host link (a chunked PCIe copy of the table is the pull) and
the 4M-entry bucket padding of a compaction's input (it bounds jit
recompiles; nothing here compiles).

Counts are int32: a table sees fewer than ``EPOCH_WINDOW_LIMIT`` = 2^31
windows (a table lifetime) before the engine pulls it, and the engine sums
the lifetimes' pulled tables in u64 (``models.engines._Lifetimes``, the
rule's one owner).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing

import numpy as np
import torch

from ..histogram import CountHistogram
from ..utils.config import default_device
from ..utils.numutil import round_pow2 as _round_pow2
from ..utils.tracing import span, trace_event
from .count import merge_runs
from .histogram import count_histogram
from .keys import _np_bias, key_dtype, sentinel
from .merge import merge_sorted
from .rle import rle_compact

#: windows per table lifetime, with headroom below 2^31 (counts are int32)
EPOCH_WINDOW_LIMIT = 1 << 31

#: device memory the entry limits below were derived for: the total that
#: ``torch.cuda.mem_get_info`` reports on an NVIDIA H100 80GB HBM3 (700.00 W),
#: chip_smoke.py phase 1's ``device_total_bytes``. Other devices scale the
#: limits by their own memory.
_REFERENCE_MEM = 85_017_493_504

#: share of a device's memory the limits leave free: the CUDA context, the
#: caching allocator's slack and the batches in flight
MEM_RESERVE = 0.10

#: device bytes of one epoch flush of n raw int64 keys, the raw keys
#: included (concatenation, torch.sort, K2): FLUSH_FIXED_BYTES +
#: FLUSH_BYTES_PER_KEY * n, the least-squares fit of chip_smoke.py phase 2's
#: peaks at 2^26, 2^28 and 2^30 keys (3,236,155,904, 12,944,587,264 and
#: 51,599,342,080 B on an NVIDIA H100 80GB HBM3, 700.00 W, torch 2.11)
FLUSH_FIXED_BYTES = 29_840_555
FLUSH_BYTES_PER_KEY = 48.03

#: device bytes of a ``merge_runs`` compaction of n merge-input entries
#: (int64 keys, int32 weights), the inputs included: the same fit of phase
#: 2's ``merge_runs`` peaks at 134M, 336M and 872M entries (8,217,125,376,
#: 20,527,888,896 and 53,277,047,296 B, the same card)
MERGE_RUNS_FIXED_BYTES = 35_371_077
MERGE_RUNS_BYTES_PER_ENTRY = 61.03

#: a compacted part: an int64 key and an int32 count an entry
PART_BYTES_PER_ENTRY = 12


def memory_budget(mem: int) -> float:
    """Device bytes the tables may take on a device of ``mem`` bytes."""
    return mem * (1 - MEM_RESERVE)


def fitting_entries(fixed: float, per_entry: float, mem: int) -> int:
    """The largest multiple of 2^24 entries n with fixed + per_entry * n
    within :func:`memory_budget` of ``mem``."""
    n = int((memory_budget(mem) - fixed) // per_entry)
    return max(n >> 24 << 24, 0)


def epoch_peak_bytes(entries: int, flush_fixed: float = FLUSH_FIXED_BYTES,
                     flush_per_key: float = FLUSH_BYTES_PER_KEY) -> float:
    """A table lifetime's worst case at an epoch of ``entries`` raw int64
    keys: the part kept from the epoch before (up to ``entries`` entries,
    as :func:`_part` stores it) beside the flush of the next. The flush
    after a part holds min(entries, EPOCH_WINDOW_LIMIT - entries) keys, so
    this bounds it, and the first flush, at every epoch size; the limit
    that fits it scales to a smaller card unchanged. The flush's fit may
    be given (chip_smoke.py passes each run's own)."""
    return flush_fixed + (PART_BYTES_PER_ENTRY + flush_per_key) * entries


#: raw entries accumulated before an epoch sort, at _REFERENCE_MEM: the
#: largest epoch whose :func:`epoch_peak_bytes` fits the budget,
#: 1,258,291,200 (chip_smoke.py phase 2 derives it again from each run's
#: fit)
EPOCH_ENTRY_LIMIT = fitting_entries(
    FLUSH_FIXED_BYTES, PART_BYTES_PER_ENTRY + FLUSH_BYTES_PER_KEY, _REFERENCE_MEM
)

#: the largest lifetime merge: two parts of EPOCH_WINDOW_LIMIT entries in
#: all, beside the merged copy of them, then that copy beside K2's output
#: (phase 2 measures 24.008 B an entry, the same card)
LIFETIME_MERGE_BYTES = 2 * PART_BYTES_PER_ENTRY * EPOCH_WINDOW_LIMIT


def _device_mem_bytes(device: torch.device) -> int | None:
    """Total memory of a CUDA device, or None (CPU)."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def _scaled_limit(env: str, tuned: int, device: torch.device) -> int:
    """``tuned`` scaled by device memory / _REFERENCE_MEM (floor 1M
    entries); the env var overrides; unscaled where memory is unqueryable
    (CPU)."""
    v = os.environ.get(env)
    if v:
        return max(int(v), 1)
    mem = _device_mem_bytes(device)
    if mem is None:
        return tuned
    return max(int(tuned * (mem / _REFERENCE_MEM)), 1 << 20)


def _table_device(device) -> torch.device:
    """A table's device: ``device``, or :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def epoch_entry_limit(device: torch.device | str | None = None) -> int:
    """Raw-entry epoch budget for ``device`` (None: the default device;
    KRUST_EPOCH_ENTRIES > scaled).

    Reads the module attribute, so tests patching ``EPOCH_ENTRY_LIMIT``
    steer it."""
    return _scaled_limit("KRUST_EPOCH_ENTRIES", EPOCH_ENTRY_LIMIT, _table_device(device))


def _epoch_concat_sort_rle(parts: list[torch.Tensor]):
    """One epoch flush: concatenate raw parts, sort, run-length compact ->
    (keys, counts, n_unique device scalar)."""
    keys = parts[0] if len(parts) == 1 else torch.cat(parts)
    parts.clear()  # the raw parts die before the sort's working set exists
    s_keys = torch.sort(keys).values
    del keys
    return rle_compact(s_keys)


def _merge_compact(a, b):
    """Merge two compacted (keys, counts) parts and re-compact (weighted).
    Given the parts' last references, it frees each input once the merge
    has read it and the merged copy once K2 has: a lifetime's last merge
    holds two copies of its entries at a time, not four."""
    m_keys, m_cnt = merge_sorted(a[0], a[1], b[0], b[1])
    del a, b
    return rle_compact(m_keys, m_cnt)


def _part(o_keys, o_cnt, n):
    """A compacted part: the first round_pow2(n) entries of a full-length
    RLE output, copied so the full-length buffers can be freed; the output
    itself where that is all of it."""
    keep = min(_round_pow2(max(n, 1)), o_keys.numel())
    if keep == o_keys.numel():
        return o_keys, o_cnt, n
    return o_keys[:keep].clone(), o_cnt[:keep].clone(), n


class PulledTable(tuple):
    """A pulled table, ``(codes, counts)``, with ``histogram``: the
    :class:`~krust_tpu_torch.histogram.CountHistogram` of its counts,
    taken on the table's device before the pull."""

    def __new__(cls, codes: np.ndarray, counts: np.ndarray, histogram: CountHistogram):
        pulled = super().__new__(cls, (codes, counts))
        pulled.histogram = histogram
        return pulled


#: entries of one chunk of the table pull: a ring slot holds one chunk's
#: keys (16 MiB at int64) and one its int32 counts (8 MiB)
PULL_CHUNK_ENTRIES = 1 << 21

#: the least entries one host thread decodes of a chunk: smaller chunks
#: take fewer threads, a small table the caller's thread alone, and a
#: chunk at most 8. The result's page faults stop scaling well before the
#: cores do: a 118M-entry pull from an H100 took 0.48-0.66 s on 4 or 8
#: threads and 0.63-0.91 s on 32, on a 32-core host
PULL_PART_ENTRIES = 1 << 18


#: the pull's pinned host buffers: two slots of (int64 keys, int32
#: counts), PULL_CHUNK_ENTRIES each, made at the first pull from a card
#: and reused by every pull from every card (pinned memory is every card's
#: under unified addressing); one pull holds _RING_LOCK at a time
_RING: list[tuple[torch.Tensor, torch.Tensor]] = []
_RING_LOCK = threading.Lock()


def _pull_ring() -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The process's ring; called under ``_RING_LOCK``."""
    if not _RING:
        _RING[:] = [(torch.empty(PULL_CHUNK_ENTRIES, dtype=torch.int64, pin_memory=True),
                     torch.empty(PULL_CHUNK_ENTRIES, dtype=torch.int32, pin_memory=True))
                    for _ in range(2)]
    return _RING


def _host_chunks(t_keys: torch.Tensor, t_cnt: torch.Tensor, step: int):
    """(start, keys, counts): numpy views of each chunk of ``step``
    entries of a table's keys and int32 counts, in order.

    A CPU table's chunks are views of its own memory. A card's pass through
    the ring: the chunk after the one being read is in flight, and a slot
    is refilled only once the caller has resumed past it."""
    n = t_keys.numel()
    if t_keys.device.type == "cpu":
        keys, cnt = t_keys.numpy(), t_cnt.numpy()
        for a in range(0, n, step):
            yield a, keys[a : a + step], cnt[a : a + step]
        return
    stream = torch.cuda.current_stream(t_keys.device)
    events = [torch.cuda.Event(), torch.cuda.Event()]

    def issue(a):
        s_keys, s_cnt = slots[a // step % 2]
        m = min(step, n - a)
        s_keys[:m].copy_(t_keys[a : a + m], non_blocking=True)
        s_cnt[:m].copy_(t_cnt[a : a + m], non_blocking=True)
        events[a // step % 2].record(stream)

    with _RING_LOCK:
        slots = [(s_keys.view(t_keys.dtype), s_cnt) for s_keys, s_cnt in _pull_ring()]
        try:
            for a in range(0, min(n, 2 * step), step):
                issue(a)
            for a in range(0, n, step):
                s_keys, s_cnt = slots[a // step % 2]
                events[a // step % 2].synchronize()
                m = min(step, n - a)
                yield a, s_keys[:m].numpy(), s_cnt[:m].numpy()
                if a + 2 * step < n:
                    issue(a + 2 * step)
        finally:  # no copy may land in a slot after the ring is released
            for e in events:
                e.synchronize()


def _decode_part(keys, cnt, codes, counts, bias) -> None:
    """Biased keys, in their unsigned view, -> u64 codes (k <= 16: u32
    keys widen, their bias XORs the same in 64 bits) and int32 counts ->
    u64, written into the result's slices."""
    np.bitwise_xor(keys, bias, out=codes)
    np.copyto(counts.view(np.int64), cnt)


def _copy_decode(t_keys, t_cnt, codes: np.ndarray, counts: np.ndarray, k: int):
    """Fill ``codes`` and ``counts`` from a table's first ``codes.size``
    keys and counts, chunk by chunk, each chunk's decode split over the
    host threads the process may run on -> (chunks, threads)."""
    n = codes.size
    step = PULL_CHUNK_ENTRIES
    threads = max(1, min(len(os.sched_getaffinity(0)), -(-min(n, step) // PULL_PART_ENTRIES)))
    udt, bias, _ = _np_bias(k)
    bias = np.uint64(bias)  # XORed into the u64 result: u32 keys widen in the XOR
    # the pool is left first: no thread reads a slot once the ring is released
    with closing(_host_chunks(t_keys, t_cnt, step)) as staged, \
            ThreadPoolExecutor(threads, "krust-pull") as pool:
        for a, keys, cnt in staged:
            m = keys.size
            ways = min(threads, -(-m // PULL_PART_ENTRIES))
            edges = [m * j // ways for j in range(ways + 1)]
            parts = [(keys[lo:hi].view(udt), cnt[lo:hi], codes[a + lo : a + hi],
                      counts[a + lo : a + hi], bias)
                     for lo, hi in zip(edges, edges[1:])]
            if ways == 1:
                _decode_part(*parts[0])
            else:
                for f in [pool.submit(_decode_part, *p) for p in parts]:
                    f.result()
            _copy_decode.chunks += 1
    return -(-n // step), threads


_copy_decode.chunks = 0


def _pull_table(t_keys, t_cnt, n: int, k: int) -> PulledTable:
    """Device -> host copy of a table's first n entries: (codes u64, counts
    u64), sorted by code, and their count-of-counts (K6, on the int32
    counts). Keys and int32 counts leave the card in chunks through the
    pinned ring; each chunk is decoded and widened straight into the
    result, the only host arrays the pull allocates."""
    with span("pull_table", entries=n, key_bytes=t_keys.element_size()) as fields:
        histogram = count_histogram(t_cnt[:n])
        codes = np.empty(n, np.uint64)
        counts = np.empty(n, np.uint64)
        chunks, threads = _copy_decode(t_keys[:n], t_cnt[:n], codes, counts, k)
        fields.update(bytes=n * (t_keys.element_size() + t_cnt.element_size()),
                      chunks=chunks, threads=threads)
    return PulledTable(codes, counts, histogram)


def _no_part(k: int, device: torch.device):
    """The finished part of a table that saw no window: (keys, counts, 0)."""
    return (torch.empty(0, dtype=key_dtype(k), device=device),
            torch.empty(0, dtype=torch.int32, device=device), 0)


class DeviceTable:
    """LSM accumulator of weighted (key, count) parts on one device:
    ``device``, keyword-only, or :func:`default_device` (the first CUDA
    device when one is visible), so a call written for ``krust_tpu``,
    ``DeviceTable(k, max_parts)``, counts on the card."""

    #: merge-input entries (pending parts + compacted table) that force a
    #: compaction, at _REFERENCE_MEM: the largest input whose ``merge_runs``
    #: peak (MERGE_RUNS_* fit) fits the budget, 1,241,513,984. Scaled by the
    #: device's memory; KRUST_PENDING_ENTRIES overrides.
    PENDING_ENTRY_LIMIT = fitting_entries(
        MERGE_RUNS_FIXED_BYTES, MERGE_RUNS_BYTES_PER_ENTRY, _REFERENCE_MEM
    )

    def __init__(self, k: int = 32, max_parts: int = 8, *,
                 device: torch.device | str | None = None):
        self._k = k
        self._device = _table_device(device)
        self._max_parts = max_parts
        self._pending_limit = _scaled_limit(
            "KRUST_PENDING_ENTRIES", type(self).PENDING_ENTRY_LIMIT, self._device
        )
        self._reset()

    def _reset(self) -> None:
        self._parts: list[tuple[torch.Tensor, torch.Tensor | None]] = []
        self._pending = 0
        # resolved table: a copy of the first round_pow2(n) merge outputs
        self._table: tuple[torch.Tensor, torch.Tensor, int] | None = None
        # unresolved merge: full-length output + device-side n
        self._merge = None
        self.windows_this_epoch = 0

    def add(self, keys: torch.Tensor, cnt: torch.Tensor | None, n_windows: int) -> None:
        """Append one batch's keys with their int32 weights (None: every
        entry counts 1; a sentinel key or a zero weight is padding)."""
        self._parts.append((keys.reshape(-1), None if cnt is None else cnt.reshape(-1)))
        self._pending += keys.numel()
        self.windows_this_epoch += n_windows
        # Parts batch up before a merge: every window is sorted once either
        # way, so fewer merges mean fewer sorts of the table and fewer
        # syncs. A merge sorts the parts AND the table, so the trigger
        # counts the table's length in, with a floor of limit / 8 pending so
        # that a huge table cannot force a merge per batch.
        held = self._table or self._merge
        table_len = held[0].numel() if held is not None else 0
        pending_cap = max(self._pending_limit - table_len, self._pending_limit // 8)
        if len(self._parts) >= self._max_parts or self._pending >= pending_cap:
            self._compact()

    def _resolve(self) -> None:
        """Turn the in-flight merge into the table: one scalar sync, which
        the batches queued since the merge overlap, and a copy of the first
        round_pow2(n) entries, so the full-length output is freed."""
        if self._merge is None:
            return
        m_keys, m_cnt, n_dev = self._merge
        self._merge = None
        n = int(n_dev.item())
        trace_event("table_compacted", unique_kmers=n)
        self._table = _part(m_keys, m_cnt, n)

    def _concat(self):
        """The merge input: every pending part, then the table. A part's
        sentinel keys weigh 0, as ``krust_tpu``'s invalid windows do, so
        that ``merge_runs`` takes them for padding (a sentinel key with a
        weight would be the all-ones code to it)."""
        keys = [p[0] for p in self._parts]
        cnt = [
            (p[0] != sentinel(p[0].dtype)).to(torch.int32) if p[1] is None
            else torch.where(p[0] == sentinel(p[0].dtype), 0, p[1].to(torch.int32))
            for p in self._parts
        ]
        if self._table is not None:
            keys.append(self._table[0])
            cnt.append(self._table[1])
        return torch.cat(keys), torch.cat(cnt)

    def _compact(self) -> None:
        self._resolve()  # syncs the previous merge; overlaps queued batches
        if not self._parts:
            return
        with span("table_compact", pending=self._pending):
            keys, cnt = self._concat()
            self._parts = []
            self._pending = 0
            self._table = None
            self._merge = merge_runs(keys, cnt)

    def _finish(self):
        """Compact to one device part, (keys, counts, n), distinct keys
        ascending in its first n entries. The table is empty afterwards."""
        self._compact()
        self._resolve()
        table = self._table
        self._reset()
        return table if table is not None else _no_part(self._k, self._device)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Compact and copy the distinct table to the host: (codes u64,
        counts u64), sorted by code. The table is empty afterwards."""
        return _pull_table(*self._finish(), self._k)


class EpochTable:
    """Epoch-sort accumulator of raw window keys on one device (``device``,
    keyword-only, as :class:`DeviceTable`'s). ``krust_tpu``'s ``interpret``
    is not taken: there is no interpret mode to ask for.

    Adaptive epoch sizing (from the TPU engine): after the first epoch
    resolves, its measured distinct count retunes the limit to
    clamp(ADAPT_DUP_TARGET * distinct, ADAPT_MIN, device budget). An
    explicit KRUST_EPOCH_ENTRIES pins the size and disables adaptation.
    """

    #: raw keys an epoch aims at per distinct key, from the third epoch on
    #: (the first epoch's distinct count is read when the second flushes).
    #: Kept at 16 on the H100 (tools/epoch_adapt_torch.py, NVIDIA H100 80GB
    #: HBM3, 700.00 W): on chip_smoke.py phase 4's read set no target moves
    #: a count (5.93-6.74 s for 16, 6.62-7.00 s for 8 after warm-up, one
    #: 61.55 GB peak); on 3 epochs at 230x, 8 was faster in all three runs
    #: (12.85-14.54 s against 13.74-15.79 s), an open question in PERF.md
    ADAPT_DUP_TARGET = 16
    #: the smallest adapted epoch: one default batch (8192 rows x 4096
    #: windows), so an epoch never holds less than a batch's keys
    ADAPT_MIN = 1 << 25

    #: epoch flushes and part merges of every epoch table in the process,
    #: counted as ``_copy_decode.chunks`` counts the pull's chunks
    flushes = 0
    part_merges = 0

    def __init__(self, k: int = 32, max_parts: int = 8, *,
                 device: torch.device | str | None = None):
        self._k = k
        self._device = _table_device(device)
        self._max_parts = max_parts
        self._epoch_limit = epoch_entry_limit(self._device)
        self._adaptive = not os.environ.get("KRUST_EPOCH_ENTRIES")
        self._reset()

    def _reset(self) -> None:
        self._raw: list[torch.Tensor] = []
        self._raw_pending = 0
        self._compacted: list[tuple[torch.Tensor, torch.Tensor, int]] = []
        # unresolved epoch: full-length sort+rle output + device-side n
        self._pending_epoch = None
        self._pending_epoch_raw = 0
        self.windows_this_epoch = 0

    def add(self, keys: torch.Tensor, n_windows: int) -> None:
        """Append one batch's raw sentinel-keyed window keys."""
        self._raw.append(keys.reshape(-1))
        self._raw_pending += keys.numel()
        self.windows_this_epoch += n_windows
        if self._raw_pending >= self._epoch_limit:
            self._flush_raw()

    def _resolve_epoch(self) -> None:
        """Sync the in-flight epoch's n and slice it into a compacted part
        (span ``epoch_resolve``); merge the parts once there are more than
        ``max_parts``."""
        if self._pending_epoch is None:
            return
        o_keys, o_cnt, n_dev = self._pending_epoch
        epoch_raw = self._pending_epoch_raw
        self._pending_epoch = None
        with span("epoch_resolve", raw=epoch_raw, retuned=False) as fields:
            n = int(n_dev.item())
            fields["unique_kmers"] = n
            trace_event("epoch_flushed", unique_kmers=n)
            if self._adaptive and epoch_raw:
                # retune from this epoch's measured duplication: high-dup data
                # prefers slices of ~ADAPT_DUP_TARGET * distinct; low-dup data
                # keeps the device-budget maximum
                self._adaptive = False  # one measurement is enough
                target = max(n, 1) * self.ADAPT_DUP_TARGET
                new_limit = min(self._epoch_limit, max(target, self.ADAPT_MIN))
                if new_limit < self._epoch_limit:
                    trace_event(
                        "epoch_limit_adapted", new=new_limit, distinct=n, raw=epoch_raw
                    )
                    self._epoch_limit = new_limit
                    fields["retuned"] = True
            self._compacted.append(_part(o_keys, o_cnt, n))
            del o_keys, o_cnt
        if len(self._compacted) > self._max_parts:
            self._merge_compacted()

    def _flush_raw(self) -> None:
        self._resolve_epoch()  # the sync overlaps the batches queued since
        if not self._raw:
            return
        with span("epoch_flush", pending=self._raw_pending,
                  key_bytes=self._raw[0].element_size()):
            EpochTable.flushes += 1
            self._pending_epoch_raw = self._raw_pending
            self._raw_pending = 0
            self._pending_epoch = _epoch_concat_sort_rle(self._raw)
            self._raw = []

    def _merge_compacted(self) -> None:
        """Merge the parts pairwise to one. Each pair leaves the list as it
        goes into the merge, so its buffers die as the merge consumes them."""
        runs, self._compacted = self._compacted, []
        while len(runs) > 1:
            nxt = []
            while len(runs) > 1:
                with span("part_merge", entries=runs[0][0].numel() + runs[1][0].numel(),
                          key_bytes=runs[0][0].element_size()):
                    EpochTable.part_merges += 1
                    o_keys, o_cnt, n_dev = _merge_compact(runs.pop(0), runs.pop(0))
                    nxt.append(_part(o_keys, o_cnt, int(n_dev.item())))
                del o_keys, o_cnt
            runs = nxt + runs
        self._compacted = runs

    def _finish(self):
        """Flush and merge to one device part, (keys, counts, n). The
        table is empty afterwards."""
        self._flush_raw()
        self._resolve_epoch()
        self._merge_compacted()
        compacted = self._compacted
        self._reset()
        return compacted[0] if compacted else _no_part(self._k, self._device)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Flush, merge to one part and copy it to the host:
        (codes u64, counts u64), sorted by code."""
        return _pull_table(*self._finish(), self._k)
