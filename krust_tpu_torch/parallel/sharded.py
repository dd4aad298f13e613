"""Multi-GPU counting: rank-local tables, one hash-sharded exchange per epoch.

Counterpart of ``krust_tpu/parallel/sharded.py`` in PyTorch's idiom: one
rank is one process on one device (:mod:`krust_tpu_torch.parallel.mesh`).

1. **Rank-local encode and tables.** Each rank feeds its own input through
   the batch engine's staging and codec kernels (K1 on the flat route, K4
   on the dense one) into its own count table: the epoch-sort
   :class:`EpochShardedTable` (the default) or the LSM
   :class:`ShardedTable`. Merges are local; nothing crosses ranks while
   batches stream.
2. **One hash-sharded exchange per epoch.** Each rank's distinct
   (key, count) entries are ordered by owner (a multiplicative hash of the
   key mod the world size) and sent with ``all_to_all_single`` at uneven
   split sizes; what arrives merges with ``ops/count.merge_runs``. After
   it, every rank holds the final counts of a disjoint hash range and pulls
   them to the host.

What must agree across ranks is the sequence of collectives. Every rank
takes the same number of batch steps (one ``all_reduce(MAX)`` up front;
a rank that runs dry takes its remaining steps with no batch), and every
step charges the table's epoch the global window count of a full batch,
world size x ``batch_rows`` x ``block_windows``. So every rank exchanges at
the same steps, and one epoch holds fewer than ``EPOCH_WINDOW_LIMIT``
windows over all ranks: a key's count, summed over ranks by the exchange,
stays an int32.

Differences from ``krust_tpu``: the split sizes cross first and the
receive buffers are sized to them, so no fixed per-destination capacity can
overflow (no ``CapacityOverflow``, no retry); flat-or-dense and the invalid
position widths are each rank's own (encode is rank-local); the result of
a rank is its own hash range, the whole table in a world of one.
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
from ..ops.table import DeviceTable, EpochTable, _pull_table
from ..utils.config import EngineConfig
from ..utils.tracing import span, trace_event
from .mesh import Mesh, make_mesh

# multiplicative mixing constants (odd, high-entropy), as krust_tpu's
_MIX1 = 0x9E3779B1
_MIX2 = 0x85EBCA77
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 of int64 ``x`` in [0, 2^32), by the 16-bit halves
    of ``c`` so that no product leaves int64 (CPU torch has no uint32
    arithmetic)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _owner_of(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Owner rank of each biased key: a multiplicative hash of its 32-bit
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
    Without a process group (a world of one) the part is already final.
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
    """One rank's LSM table (``EngineConfig(use_epoch_sort=False)``)."""

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8):
        super().__init__(k, mesh.device, max_parts)
        self._mesh = mesh


class EpochShardedTable(_Exchanged, EpochTable):
    """One rank's epoch-sort table, the default. Its epoch holds the
    device budget over the world size (at least 2^20 entries), as
    ``krust_tpu`` sizes it."""

    def __init__(self, k: int, mesh: Mesh, max_parts: int = 8):
        super().__init__(k, mesh.device, max_parts)
        self._mesh = mesh
        self._epoch_limit = max(self._epoch_limit // mesh.size, 1 << 20)


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
    """Count this rank's input across the mesh; exact.

    Every rank of the mesh calls it with its own input. Returns the table
    of this rank's hash range: disjoint from every other rank's, their
    union the count of all ranks' input. In a world of one that is the
    whole table. The device is ``mesh.device``; without a mesh,
    ``config.device`` or this rank's GPU (no CPU fallback).
    """
    cfg = config or EngineConfig()
    mesh = mesh or make_mesh(device=cfg.device)
    engine = BatchEngine(replace(cfg, device=mesh.device))
    table = (EpochShardedTable if cfg.use_epoch_sort else ShardedTable)(k, mesh)
    n_bases = streams.codes.shape[0]
    steps = _all_max(mesh, batch_count(n_bases, k, cfg.block_windows, cfg.batch_rows))
    charge = mesh.size * cfg.batch_rows * cfg.block_windows
    pacer = _ProgressPacer(
        tracker, progress, streams.n_records, streams.n_bases, max(n_bases - k + 1, 0)
    )
    epochs = []
    fed = engine._feed_streams(
        streams, k, min_quality, table, epochs, pacer.step, charge, "sharded_encode"
    )
    for _ in range(steps - fed):  # ran dry: keep the other ranks' exchange steps
        if table.windows_this_epoch + charge >= table_mod.EPOCH_WINDOW_LIMIT:
            epochs.append(table.finalize())
        table.windows_this_epoch += charge
    pacer.finish()
    epochs.append(table.finalize())
    return BatchEngine._merge_epochs(epochs, k)
