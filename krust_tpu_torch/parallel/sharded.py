"""Multi-GPU counting: a table per device slot, one hash-sharded exchange a table lifetime.

Counterpart of ``krust_tpu/parallel/sharded.py``. A mesh
(:mod:`krust_tpu_torch.parallel.mesh`) is one process over every local GPU,
or the ranks of a ``torch.distributed`` group that each drive their share
of their host's GPUs; either way, one table slot per device.

1. **Slot-local encode and tables.** The batch engine's staging and codec
   kernels (K1 on the flat route, K4 on the dense one) feed each slot's
   own count table on the slot's device: the epoch-sort
   :class:`EpochShardedTable` (the default) or the LSM
   :class:`ShardedTable`. A process deals its batches to its slots in
   turn. Merges are local; nothing crosses devices while batches stream.
2. **One hash-sharded exchange a lifetime** (:func:`_exchange`, one path for
   every form of mesh). Slot l of rank r is global slot ``r * L + l``,
   ``krust_tpu``'s device order (its mesh takes ``jax.devices()`` in
   order, process by process); each slot's distinct (key, count) entries
   are ordered by owner (``krust_tpu``'s multiplicative hash of the code
   mod the mesh's slots, so a slot's shard is the chip's) and cut at the
   owners' counts. Pieces between a process's slots move by ``Tensor.to``
   (a peer copy between cards); pieces for other ranks cross with uneven
   ``all_to_all_single`` calls on the rank's first device, one round per
   destination slot. Each destination merges its pieces, key-sorted
   already, with the merge kernel (K3) and the RLE kernel (K2); a rank's
   disjoint shards then merge with K3 into one key-sorted table on its
   first device, and the rank pulls it: the whole table in one process,
   the rank's hash ranges in a group.

Spans (``utils.tracing.span``): ``sharded_encode`` (a batch, in the
feed), ``sharded_exchange`` (the whole exchange; its fields ``devices``,
``sent_bytes``, ``process_bytes`` and ``wire_bytes``), inside it
``exchange_cut`` (the first ``_by_owner`` through the one host sync of
the size matrix) and ``exchange_merge`` (one a destination slot: its
pieces' copies, its K3 merges and K2, through the sync on its entry
count), and ``gather_shards`` (the K3 merges of the shards on the first
device, through a sync of that device, so its seconds are the gather's
and not its launches'); event ``shard_sizes`` (one size a slot).

A table lifetime ends before the next group of batches could bring the
table's windows to ``EPOCH_WINDOW_LIMIT``, by the engine's rule
(``models.engines._Lifetimes``): a batch charges every process a full
batch, ranks x ``batch_rows`` x ``block_windows`` windows, and a group is
a batch on every slot of the rank. One lifetime so holds fewer than
``EPOCH_WINDOW_LIMIT`` windows over all slots, and a key's count, summed
by the exchange, stays an int32. In a process group what must agree
across ranks is the sequence of collectives: every rank feeds the same
number of batches (one ``all_reduce(MAX)`` up front; a rank that runs dry
charges its remaining batches with none), and every rank has as many
slots, so every rank exchanges at the same batches.

Differences from ``krust_tpu``: the split sizes are known before the
pieces move and the receive buffers are sized to them, so no fixed
per-destination capacity can overflow (``CapacityOverflow`` is never
raised, ``capacity_factor`` is checked and unused, no retry);
flat-or-dense and the invalid position widths are each rank's own
(encode is rank-local); a slot's batch is ``batch_rows`` rows.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist

from ..io.packer import batch_count
from ..io.reader import ParsedStreams
from ..models.engines import BatchEngine, PackedCounts, _Lifetimes, _ProgressPacer
from ..ops.merge import merge_sorted
from ..ops.rle import rle_compact
from ..ops.table import DeviceTable, EpochTable, _no_part, _part, _pull_table
from ..utils.config import EngineConfig
from ..utils.tracing import span, trace_event
from .mesh import Mesh, make_mesh

# multiplicative mixing constants (odd, high-entropy), as krust_tpu's
_MIX1 = 0x9E3779B1
_MIX2 = 0x85EBCA77
_M32 = 0xFFFFFFFF

#: the fewest entries a slot's epoch (or LSM pending set) holds, however
#: many slots share the device budget
MIN_SLOT_ENTRIES = 1 << 20

#: keys hashed to their owners at a time in the in-process exchange, which
#: bounds its int64 temporaries
_OWNER_CHUNK = 1 << 26


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 of int64 ``x`` in [0, 2^32), by the 16-bit halves
    of ``c`` so that no product leaves int64 (CPU torch has no uint32
    arithmetic)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _owner_of(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Owner slot of each biased key, ``krust_tpu``'s owner chip: the
    multiplicative hash of the code's 32-bit halves (``hi``, ``lo``: ``key
    ^ 2^63`` split for int64 keys, ``lo`` = ``key + 2^31`` and ``hi`` = 0
    for int32 keys), mod n (int64). Global slot g owns what chip g of
    ``krust_tpu``'s mesh owns, for every n."""
    if keys.dtype == torch.int64:
        code = keys ^ torch.iinfo(torch.int64).min
        h = _mul32(code & _M32, _MIX2) ^ _mul32((code >> 32) & _M32, _MIX1)
    else:
        h = _mul32(keys.to(torch.int64) + (1 << 31), _MIX2)
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    return h % n


def _by_owner(part, n: int):
    """A slot's finished part ``(keys, counts, m)`` ordered by owner slot,
    key order kept within each owner (a stable sort of the owners), and
    the entries per owner (int64 [n], on the part's device)."""
    keys, cnt, m = part
    keys, cnt = keys[:m], cnt[:m]  # no sentinel among the first m
    owner = torch.empty(m, dtype=torch.int16, device=keys.device)
    for i in range(0, m, _OWNER_CHUNK):
        owner[i : i + _OWNER_CHUNK] = _owner_of(keys[i : i + _OWNER_CHUNK], n)
    per_owner = torch.bincount(owner, minlength=n)
    order = torch.sort(owner, stable=True).indices
    del owner
    return keys[order], cnt[order], per_owner


def _merge_sorted_all(pieces: list, device):
    """Merge key-sorted (keys, counts) pieces into one on ``device`` with
    K3, pairwise in turn; None if all are empty. Each piece moves there (a
    peer copy from another card) only when its merge comes, and leaves the
    list as it goes in, so the list's references die as merges consume
    them (the list is empty afterwards)."""
    pieces[:] = [p for p in pieces if p[0].numel()]
    if not pieces:
        return None
    while len(pieces) > 1:
        a, b = pieces.pop(0), pieces.pop(0)
        pieces.append(merge_sorted(a[0].to(device), a[1].to(device),
                                   b[0].to(device), b[1].to(device)))
        del a, b
    keys, cnt = pieces.pop()
    return keys.to(device), cnt.to(device)


def _cross(pieces, send, recv, slot: int, mesh: Mesh):
    """Round ``slot`` of the exchange between ranks, a collective: the
    pieces of this rank's slots bound for slot ``slot`` of every other
    rank cross in two uneven ``all_to_all_single`` calls (keys, then
    counts) on the first device, the one device of the process's
    collectives. Returns what this rank's slot ``slot`` gets from every
    slot of every other rank: key-sorted ``(keys, counts)`` pieces on the
    first device. ``send[s][g]`` is what local slot s sends global slot g,
    ``recv[r][s][l]`` what slot s of rank r sends local slot l."""
    n_local, first = len(mesh.devices), mesh.device
    out = [[0 if r == mesh.rank else send[s][r * n_local + slot] for s in range(n_local)]
           for r in range(mesh.world)]
    into = [[0 if r == mesh.rank else recv[r][s][slot] for s in range(n_local)]
            for r in range(mesh.world)]
    got = []
    for part in (0, 1):  # keys, then counts: one payload on the card at a time
        buf = pieces[0][part][0].new_empty(sum(map(sum, out)), device=first)
        at = 0
        for r, row in enumerate(out):
            for s, n in enumerate(row):
                if n:  # a peer copy, ordered on the first device's current stream
                    buf[at : at + n].copy_(pieces[s][part][r * n_local + slot])
                    at += n
        arrived = buf.new_empty(sum(map(sum, into)))
        dist.all_to_all_single(arrived, buf, list(map(sum, into)), list(map(sum, out)),
                               group=mesh.group)
        del buf
        got.append(arrived.split([n for row in into for n in row]))
    return list(zip(*got))


def _exchange(parts, mesh: Mesh, k: int):
    """The hash-sharded exchange of one rank's slots, the same in every
    form of mesh: slot l of rank r is global slot ``r * L + l`` (L slots a
    rank), and each entry goes to the global slot its key hashes to. Each
    slot's finished part ``(keys, counts, n)`` is cut by owner; the split
    sizes reach the host in one sync (after one ``all_to_all_single`` of
    the size matrix in a process group); pieces between this rank's slots
    move by peer copy, pieces for other ranks cross in one round per
    destination slot (:func:`_cross`); each of this rank's slots merges its
    key-sorted pieces with K3, then K2 sums the keys that several slots
    saw. Returns this rank's slots' hash ranges as ``(keys, counts, n)``,
    disjoint and key-sorted, each on its slot's device. A collective in a
    process group: every rank calls it at the same step. Without one, a
    mesh of one slot exchanges nothing. Empties ``parts``: each part dies
    once it is cut."""
    devices, n_local, rank = mesh.devices, len(mesh.devices), mesh.rank
    if mesh.group is None and n_local == 1:  # the part is already final
        trace_event("shard_sizes", sizes=[parts[0][2]])
        return [parts.pop()]
    with span("sharded_exchange", devices=mesh.size) as fields:
        with span("exchange_cut", slots=mesh.size):
            cut = []
            while parts:  # each part dies once its ordered copy exists
                cut.append(_by_owner(parts.pop(0), mesh.size))
            sizes = torch.stack([c[2].to(mesh.device) for c in cut])  # [L, world * L]
            if mesh.group is not None:  # [world, L, L]: what each rank's slots send ours
                got = torch.empty(mesh.world, n_local, n_local, dtype=sizes.dtype,
                                  device=mesh.device)
                dist.all_to_all_single(
                    got, sizes.view(n_local, mesh.world, n_local).transpose(0, 1).contiguous(),
                    group=mesh.group)
                sizes = torch.cat([sizes.flatten(), got.flatten()])
            flat = sizes.flatten().tolist()  # the one host sync
        send = [flat[s * mesh.size : (s + 1) * mesh.size] for s in range(n_local)]
        at = n_local * mesh.size
        recv = [[flat[at + (r * n_local + s) * n_local : at + (r * n_local + s + 1) * n_local]
                 for s in range(n_local)] for r in range(mesh.world)]
        entry = cut[0][0].element_size() + cut[0][1].element_size()
        pieces = [(keys.split(row), cnt.split(row))
                  for (keys, cnt, _), row in zip(cut, send)]
        del cut
        remote = [n for row in send for g, n in enumerate(row) if g // n_local != rank]
        local = [row[rank * n_local + d] for s, row in enumerate(send)
                 for d in range(n_local) if devices[s] != devices[d]]
        fields["sent_bytes"] = entry * sum(map(sum, send))
        fields["process_bytes"] = entry * sum(remote)
        fields["wire_bytes"] = entry * (sum(remote) + sum(local))
        shards = []
        for d, dev in enumerate(devices):
            g = rank * n_local + d
            with span("exchange_merge", slot=g):
                mine = [(keys[g], cnt[g]) for keys, cnt in pieces]
                if mesh.world > 1:
                    mine += _cross(pieces, send, recv, d, mesh)
                merged = _merge_sorted_all(mine, dev)
                if merged is None:
                    shards.append(_no_part(k, dev))
                    continue
                o_keys, o_cnt, n_dev = rle_compact(*merged)
                del merged
                shards.append(_part(o_keys, o_cnt, int(n_dev.item())))
                del o_keys, o_cnt
    trace_event("shard_sizes", sizes=[s[2] for s in shards])
    return shards


def _gather(shards, device, k: int):
    """The slots' shards, disjoint hash ranges each key-sorted, as one
    key-sorted table ``(keys, counts, n)`` on ``device`` (K3 merges; no
    key repeats, so no K2), finished on a CUDA ``device`` before it
    returns; one shard is the table as it is. Empties ``shards``."""
    if len(shards) == 1:
        return shards.pop()
    n = sum(s[2] for s in shards)
    with span("gather_shards", entries=n):
        views = [(keys[:m], cnt[:m]) for keys, cnt, m in shards]
        shards.clear()  # each shard dies once its merge has read it
        merged = _merge_sorted_all(views, device)
        if device.type == "cuda":  # the span ends with the merges, not their launches
            torch.cuda.synchronize(device)
    if merged is None:
        return _no_part(k, device)
    return merged[0], merged[1], n


class CapacityOverflow(RuntimeError):
    """``krust_tpu``'s exchange error: a hash shard's destination outgrew its
    fixed capacity. The port never raises it: its exchange learns the split
    sizes before the pieces move and sizes every buffer to them, so there
    is no fixed capacity to exceed. Exported so that code written against
    ``krust_tpu`` (``except CapacityOverflow``) imports unchanged."""


class _Exchanged:
    """A slot's table whose finished part is exchanged before the pull."""

    _mesh: Mesh

    def exchange(self, capacity_factor: int = 4):
        """Finish this table and exchange it, on a mesh of one slot a rank:
        this rank's owned ``(keys, counts, n)`` on its device. A collective:
        every rank calls it at the same step. The table is empty
        afterwards. Several slots a rank exchange together, through
        :class:`_Slots`. ``capacity_factor`` is ``krust_tpu``'s first rung
        of capacity (at least 1, as there); the port sizes its buffers to
        the split sizes, so it is otherwise unused."""
        if capacity_factor < 1:
            raise ValueError(f"capacity_factor={capacity_factor}: at least 1")
        if len(self._mesh.devices) != 1:
            raise ValueError("a table exchanges alone only on a mesh of one slot a rank")
        return _exchange([self._finish()], self._mesh, self._k)[0]

    def finalize(self):
        """:meth:`exchange`, then copy this rank's hash range to the host:
        (codes u64, counts u64), sorted by code."""
        return _pull_table(*self.exchange(), self._k)


class ShardedTable(_Exchanged, DeviceTable):
    """One slot's LSM table (``EngineConfig(use_epoch_sort=False)``) on
    ``mesh.devices[slot]``. Its pending limit is the device budget over
    the mesh's slots (at least ``MIN_SLOT_ENTRIES``), as the epoch table's
    epoch is."""

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8, slot: int = 0):
        super().__init__(k, max_parts, device=mesh.devices[slot])
        self._mesh = mesh
        self._pending_limit = max(self._pending_limit // mesh.size, MIN_SLOT_ENTRIES)


class EpochShardedTable(_Exchanged, EpochTable):
    """One slot's epoch-sort table, the default, on ``mesh.devices[slot]``.
    Its epoch holds the device budget over the mesh's slots (at least
    ``MIN_SLOT_ENTRIES``), as ``krust_tpu`` sizes it."""

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8, slot: int = 0):
        super().__init__(k, max_parts, device=mesh.devices[slot])
        self._mesh = mesh
        self._epoch_limit = max(self._epoch_limit // mesh.size, MIN_SLOT_ENTRIES)


class _Slots:
    """The tables of this process's slots, fed as one table: the feed
    stages batch i on ``devices[i % n]`` and :meth:`add` hands it to slot
    i mod n. :meth:`finalize` ends a table lifetime: the exchange
    (:func:`_exchange`), the gather of this rank's shards on its first
    device and one pull."""

    def __init__(self, k: int, mesh: Mesh, table_cls):
        self._k = k
        self._mesh = mesh
        self.devices = mesh.devices
        self._tables = [table_cls(k, mesh, slot=i) for i in range(len(mesh.devices))]
        self._next = 0

    def add(self, keys: torch.Tensor, *rest) -> None:
        """One batch, on the next slot's device; ``rest`` is what the
        slot's table takes after the keys (weights, the window charge)."""
        if keys.device != self._tables[self._next]._device:
            raise ValueError(f"slot {self._next} is on {self.devices[self._next]}, "
                             f"the batch on {keys.device}")
        self._tables[self._next].add(keys, *rest)
        self._next = (self._next + 1) % len(self._tables)

    def finalize(self):
        """End the lifetime, a collective in a process group: this rank's
        hash ranges on the host, (codes u64, counts u64) sorted by code.
        The slots are empty afterwards."""
        self._next = 0
        shards = _exchange([t._finish() for t in self._tables], self._mesh, self._k)
        return _pull_table(*_gather(shards, self.devices[0], self._k), self._k)


def _all_max(mesh: Mesh, value: int) -> int:
    """The largest ``value`` over the ranks."""
    if mesh.group is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def count_sharded(
    streams: ParsedStreams,
    k: int,
    min_quality: int | None = None,
    mesh: Mesh | None = None,
    config: EngineConfig | None = None,
    progress=None,
    tracker=None,
) -> PackedCounts:
    """Count this process's input across the mesh; exact.

    Without a process group, one call counts the input over every slot of
    the mesh and returns the whole table. In a process group every rank
    calls it with its own input, counts it over its own slots and gets the
    table of its slots' hash ranges: disjoint from every other rank's,
    their union the count of all ranks' input. Without a mesh: every
    visible GPU (in a group, the rank's share of its host's GPUs), or
    ``config.device`` alone when it names one (no CPU fallback).
    """
    cfg = config or EngineConfig()
    mesh = mesh or make_mesh(device=cfg.device)
    engine = BatchEngine(replace(cfg, device=mesh.device))
    # a batch charges a full batch on every process: a group of a batch on
    # every slot of the rank charges every slot of the mesh one
    lifetimes = _Lifetimes(
        _Slots(k, mesh, EpochShardedTable if cfg.use_epoch_sort else ShardedTable),
        not cfg.use_epoch_sort, mesh.world * cfg.batch_rows * cfg.block_windows,
    )
    n_bases = streams.codes.shape[0]
    steps = _all_max(mesh, batch_count(n_bases, k, cfg.block_windows, cfg.batch_rows))
    pacer = _ProgressPacer(
        tracker, progress, streams.n_records, streams.n_bases, max(n_bases - k + 1, 0)
    )
    engine._feed_streams(streams, k, min_quality, lifetimes, pacer.step, "sharded_encode")
    while lifetimes.batches < steps:  # ran dry: charged as the other ranks' batches are
        lifetimes.charge()
    pacer.finish()
    return lifetimes.result(k)
