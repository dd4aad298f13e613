"""Device counting: sort-based unique + count with front compaction.

Counterpart of ``krust_tpu/ops/count.py``, on the port's keys
(:mod:`krust_tpu_torch.ops.keys`: one biased int32 / int64 key, the dtype's
maximum as the sentinel, int32 counts). Each function sorts its keys with
``torch.sort`` (where ``krust_tpu`` calls ``lax.sort``) and hands the sorted
stream to the RLE kernel (:func:`~krust_tpu_torch.ops.rle.rle_compact`, K2,
the successor of these functions in the TPU engine too), which sums each
run and packs the distinct keys to the front in one pass. What is kept of
``krust_tpu``'s functions is each one's table: the entries with count > 0,
in key order, and ``n_unique``. What is not: the (hi, lo) pairs and the
k-dependent choice of sort operands (the key width carries it), the second
compaction sort and the cumsum / cummax segment sums (K2 does both), and
zero-scrubbed padding (padding is the sentinel key with count 0
everywhere).

One difference at k = 32. ``krust_tpu`` carries an invalid flag beside the
keys there and so counts the all-ones code with a weight > 0 as a real key;
here that code is the sentinel and is dropped. It is the all-T 32-mer,
whose reverse complement all-A is smaller, so it is never canonical and no
input produces it.

Every result is as long as its input and stays on the keys' device;
``n_unique`` is a 1-element int64 tensor that is not synchronized here.
"""

from __future__ import annotations

import torch

from .keys import sentinel
from .rle import rle_compact


def _sort_rle(keys: torch.Tensor, weight: torch.Tensor, valid: torch.Tensor):
    """Invalid entries to sentinels, keys ascending with each weight
    following its key, then K2. Each temporary dies as soon as it is
    consumed: the sort's working set is the peak."""
    masked = torch.where(valid, keys, sentinel(keys.dtype))
    s_keys, order = torch.sort(masked)
    del masked
    s_weight = weight[order]
    del order
    return rle_compact(s_keys, s_weight)


def merge_weighted(keys: torch.Tensor, weight: torch.Tensor, valid: torch.Tensor):
    """Sum the weights of each distinct valid key, compacted to the front.

    Args:
      keys: int32 / int64 biased keys (any shape; flattened).
      weight: int32 weights, one per key.
      valid: bool; invalid entries are dropped.

    Returns:
      (u_keys, u_cnt, n_unique): the distinct valid keys ascending with their
      summed weights in the first ``n_unique`` slots (a valid key whose
      weights sum to 0 keeps its slot), sentinel keys and zero counts after.
    """
    return _sort_rle(
        keys.reshape(-1), weight.reshape(-1).to(torch.int32), valid.reshape(-1).bool()
    )


def count_unique(keys: torch.Tensor, valid: torch.Tensor):
    """Occurrences of each distinct valid key: :func:`merge_weighted` with
    unit weights."""
    keys = keys.reshape(-1)
    masked = torch.where(valid.reshape(-1).bool(), keys, sentinel(keys.dtype))
    return rle_compact(torch.sort(masked).values)


def count_runs(keys: torch.Tensor, valid: torch.Tensor):
    """One batch's distinct keys and counts as a weighted part for
    :class:`~krust_tpu_torch.ops.table.DeviceTable`: (keys, counts) of the
    input's length, entries with count 0 padding. ``krust_tpu`` leaves each
    count at its run's last position to save a compaction; K2 compacts in
    the same pass, so the entries come packed to the front."""
    u_keys, u_cnt, _ = count_unique(keys, valid)
    return u_keys, u_cnt


def merge_runs(keys: torch.Tensor, weight: torch.Tensor):
    """Weighted merge with front compaction: the table merge.

    :func:`merge_weighted` where an entry with weight 0 is padding: it
    becomes a sentinel before the sort, so a key whose weights are all 0
    takes no slot.
    """
    weight = weight.reshape(-1).to(torch.int32)
    return _sort_rle(keys.reshape(-1), weight, weight > 0)


def merge_runs_presorted(keys: torch.Tensor, weight: torch.Tensor):
    """:func:`merge_runs` of a stream that is key-sorted already, sentinels
    at the back: no key sort, K2 alone.

    A run is emitted only if its weights sum to more than 0, while K2 keeps
    every run of its input. So the entries with weight 0 are dropped first:
    they become sentinels and move behind the others by a stable one-byte
    sort, which keeps the key order K2 needs.
    """
    keys = keys.reshape(-1)
    weight = weight.reshape(-1).to(torch.int32)
    dead = weight <= 0
    order = torch.sort(dead.to(torch.uint8), stable=True).indices
    live_first = torch.where(dead, sentinel(keys.dtype), keys)[order]
    return rle_compact(live_first, weight[order])
