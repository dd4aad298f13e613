"""Multi-GPU counting: a table per device slot, one hash-sharded exchange per epoch.

Counterpart of ``krust_tpu/parallel/sharded.py``. A mesh
(:mod:`krust_tpu_torch.parallel.mesh`) is either one process over every
local GPU, one table slot per device, or one process per GPU in a
``torch.distributed`` group.

1. **Slot-local encode and tables.** The batch engine's staging and codec
   kernels (K1 on the flat route, K4 on the dense one) feed each slot's
   own count table on the slot's device: the epoch-sort
   :class:`EpochShardedTable` (the default) or the LSM
   :class:`ShardedTable`. In one process, batches are dealt to the slots
   in turn. Merges are local; nothing crosses devices while batches
   stream.
2. **One hash-sharded exchange per epoch.** Each slot's distinct
   (key, count) entries are ordered by owner (a multiplicative hash of the
   key mod the number of slots) and cut at the owners' counts. In one
   process each destination gathers its pieces with ``Tensor.to`` (a peer
   copy between cards) and merges them, which are key-sorted already, with
   the merge kernel (K3) and the RLE kernel (K2); the disjoint shards then
   merge with K3 into one key-sorted table on the first device, and the
   process pulls the whole table. In a process group the pieces cross
   with ``all_to_all_single`` at uneven split sizes and merge with
   ``ops/count.merge_runs``; every rank pulls its own hash range.

An epoch ends before the next step could bring the table's windows to
``EPOCH_WINDOW_LIMIT``: a step is a batch on every slot of the mesh and
charges every slot a full batch, slots x ``batch_rows`` x
``block_windows`` windows. One epoch so holds fewer than
``EPOCH_WINDOW_LIMIT`` windows over all slots, and a key's count, summed
by the exchange, stays an int32. In a process group what must agree
across ranks is the sequence of collectives: every rank takes the same
number of steps (one ``all_reduce(MAX)`` up front; a rank that runs dry
takes its remaining steps with no batch), so every rank exchanges at the
same steps.

Differences from ``krust_tpu``: the split sizes are known before the
pieces move and the receive buffers are sized to them, so no fixed
per-destination capacity can overflow (no ``CapacityOverflow``, no
retry); flat-or-dense and the invalid position widths are each rank's own
(encode is rank-local); a rank of a process group drives one device, and
its result is its own hash range.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.distributed as dist

from ..io.packer import batch_count
from ..io.reader import ParsedStreams
from ..models.engines import BatchEngine, PackedCounts, _ProgressPacer
from ..ops import table as table_mod
from ..ops.count import merge_runs
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
    """Owner slot of each biased key: a multiplicative hash of its 32-bit
    halves, mod n (int64)."""
    k = keys.to(torch.int64)
    h = _mul32(k & _M32, _MIX2)
    if keys.dtype == torch.int64:
        h = h ^ _mul32((k >> 32) & _M32, _MIX1)
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    return h % n


def _exchange_and_merge(part, mesh: Mesh):
    """Send each entry of this rank's finished part ``(keys, counts, n)`` to
    its owner, merge what arrives: this rank's hash range as
    ``(keys, counts, n)`` on its device. A collective: every rank calls it.
    Without a process group (a mesh of one slot) the part is already final.
    Given the part's last reference, it frees each buffer once the next
    step has it: the merge holds what arrived, not what was sent."""
    keys, cnt, n = part
    if mesh.group is None:
        trace_event("shard_sizes", sizes=[n])
        return part
    del part
    with span("sharded_exchange", devices=mesh.size) as fields:
        keys, cnt = keys[:n], cnt[:n]  # no sentinel among the first n
        owner, order = torch.sort(_owner_of(keys, mesh.size))
        keys, cnt = keys[order], cnt[order]
        del order
        per_owner = torch.bincount(owner, minlength=mesh.size)
        del owner
        # one all-to-all tells each rank what it gets from each rank and
        # what each rank sends in all
        meta = torch.stack([per_owner, per_owner.sum().expand(mesh.size)], 1)
        got = torch.empty_like(meta)
        dist.all_to_all_single(got, meta, group=mesh.group)
        got = got.cpu()
        send, recv = per_owner.tolist(), got[:, 0].tolist()
        r_keys, r_cnt = keys.new_empty(sum(recv)), cnt.new_empty(sum(recv))
        dist.all_to_all_single(r_keys, keys, recv, send, group=mesh.group)
        dist.all_to_all_single(r_cnt, cnt, recv, send, group=mesh.group)
        del keys, cnt
        fields["wire_bytes"] = int(got[:, 1].sum()) * (r_keys.element_size()
                                                       + r_cnt.element_size())
        m_keys, m_cnt, n_dev = merge_runs(r_keys, r_cnt)
        n = int(n_dev.item())
    trace_event("shard_sizes", sizes=[n])
    return m_keys, m_cnt, n


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


def _exchange_local(parts, devices, k: int):
    """The in-process exchange of one process's slots: each slot's finished
    part ``(keys, counts, n)`` is cut by owner, and slot d's pieces from
    every slot merge on ``devices[d]`` (K3, then K2 to sum the keys that
    several slots saw). Returns each slot's hash range as ``(keys, counts,
    n)``, disjoint and key-sorted. Empties ``parts``: each part dies
    once it is cut."""
    n_slots = len(devices)
    with span("sharded_exchange", devices=n_slots) as fields:
        cut = []
        while parts:  # each part dies once its ordered copy exists
            cut.append(_by_owner(parts.pop(0), n_slots))
        # every slot's split sizes, read in one host sync
        sizes = torch.stack([c[2].to(devices[0]) for c in cut]).tolist()
        entry = cut[0][0].element_size() + cut[0][1].element_size()
        pieces = [(keys.split(row), cnt.split(row))
                  for (keys, cnt, _), row in zip(cut, sizes)]
        del cut
        fields["sent_bytes"] = sum(map(sum, sizes)) * entry
        fields["wire_bytes"] = entry * sum(
            sizes[s][d] for s in range(n_slots) for d in range(n_slots)
            if devices[s] != devices[d])
        shards = []
        for d, dev in enumerate(devices):
            mine = [(keys[d], cnt[d]) for keys, cnt in pieces]
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
    key repeats, so no K2). Empties ``shards``."""
    n = sum(s[2] for s in shards)
    with span("gather_shards", entries=n):
        views = [(keys[:m], cnt[:m]) for keys, cnt, m in shards]
        shards.clear()  # each shard dies once its merge has read it
        merged = _merge_sorted_all(views, device)
    if merged is None:
        return _no_part(k, device)
    return merged[0], merged[1], n


class _Exchanged:
    """A rank's table whose finished part is exchanged before the pull."""

    _mesh: Mesh

    def exchange(self):
        """Finish this rank's table and exchange it: this rank's owned
        ``(keys, counts, n)`` on its device. A collective: every rank
        calls it at the same step. The table is empty afterwards."""
        return _exchange_and_merge(self._finish(), self._mesh)

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
        super().__init__(k, mesh.devices[slot], max_parts)
        self._mesh = mesh
        self._pending_limit = max(self._pending_limit // mesh.size, MIN_SLOT_ENTRIES)


class EpochShardedTable(_Exchanged, EpochTable):
    """One slot's epoch-sort table, the default, on ``mesh.devices[slot]``.
    Its epoch holds the device budget over the mesh's slots (at least
    ``MIN_SLOT_ENTRIES``), as ``krust_tpu`` sizes it."""

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8, slot: int = 0):
        super().__init__(k, mesh.devices[slot], max_parts)
        self._mesh = mesh
        self._epoch_limit = max(self._epoch_limit // mesh.size, MIN_SLOT_ENTRIES)


class _Slots:
    """The tables of this process's slots, fed as one table: the feed
    stages batch i on ``devices[i % n]`` and :meth:`add` hands it to slot
    i mod n. :meth:`finalize` ends an epoch: with one slot, the slot's own
    (the rank's exchange in a process group); with several, the in-process
    exchange, the gather of the shards on the first device and one pull."""

    def __init__(self, k: int, mesh: Mesh, table_cls):
        self._k = k
        self.devices = mesh.devices
        self._tables = [table_cls(k, mesh, slot=i) for i in range(len(mesh.devices))]
        self._next = 0
        self.windows_this_epoch = 0

    def add(self, keys: torch.Tensor, *rest) -> None:
        """One batch, on the next slot's device; ``rest`` is what the
        slot's table takes after the keys (weights, the window charge)."""
        if keys.device != self._tables[self._next]._device:
            raise ValueError(f"slot {self._next} is on {self.devices[self._next]}, "
                             f"the batch on {keys.device}")
        self._tables[self._next].add(keys, *rest)
        self._next = (self._next + 1) % len(self._tables)
        self.windows_this_epoch += rest[-1]

    def finalize(self):
        """End the epoch: the whole table of this process's hash ranges on
        the host, (codes u64, counts u64) sorted by code. The slots are
        empty afterwards."""
        self._next = 0
        self.windows_this_epoch = 0
        if len(self._tables) == 1:  # a mesh of one device: no exchange in process
            return self._tables[0].finalize()
        shards = _exchange_local([t._finish() for t in self._tables], self.devices, self._k)
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
    calls it with its own input and gets the table of its own hash range:
    disjoint from every other rank's, their union the count of all ranks'
    input. Without a mesh: every visible GPU, or ``config.device`` alone
    when it names one (no CPU fallback).
    """
    cfg = config or EngineConfig()
    mesh = mesh or make_mesh(device=cfg.device)
    engine = BatchEngine(replace(cfg, device=mesh.device))
    table = _Slots(k, mesh, EpochShardedTable if cfg.use_epoch_sort else ShardedTable)
    n_bases = streams.codes.shape[0]
    steps = _all_max(mesh, batch_count(n_bases, k, cfg.block_windows, cfg.batch_rows))
    # a batch charges a full batch on every process: a step, a batch on
    # every slot, charges every slot of the mesh one
    charge = mesh.size // len(mesh.devices) * cfg.batch_rows * cfg.block_windows
    pacer = _ProgressPacer(
        tracker, progress, streams.n_records, streams.n_bases, max(n_bases - k + 1, 0)
    )
    epochs = []
    fed = engine._feed_streams(
        streams, k, min_quality, table, epochs, pacer.step, charge, "sharded_encode",
        mesh.devices,
    )
    for _ in range(steps - fed):  # ran dry: keep the other ranks' exchange steps
        if table.windows_this_epoch + charge >= table_mod.EPOCH_WINDOW_LIMIT:
            epochs.append(table.finalize())
        table.windows_this_epoch += charge
    pacer.finish()
    epochs.append(table.finalize())
    return BatchEngine._merge_epochs(epochs, k)
