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

The all-ones code. The port's sentinel key is the all-ones code (the
all-T 16-mer in int32 keys, the all-T 32-mer in int64 keys), while
``krust_tpu`` decides validity by its ``valid`` argument (``merge_weighted``,
``count_unique``) or, at k = 32, by a flag beside the keys (``count_runs``,
and ``merge_runs`` through ``merge_weighted``). So as there, an entry under
the sentinel key that is valid is the all-ones code and counts:
``merge_weighted`` and ``count_unique`` at every key width (a valid entry
of weight 0 keeps its slot), ``count_runs`` and ``merge_runs`` (``weight >
0`` for valid) for int64 keys (k = 32 is the only int64 width where the
all-ones code is a k-mer code; ``krust_tpu`` drops it at k = 16 there).
Such entries are summed on the side of the sort and K2 and written as one
entry at slot ``n_unique``, which holds the sentinel key already and sorts
last, and ``n_unique`` grows by one. No input of the counting path makes
such an entry (the all-T 32-mer is never canonical), and the
``DeviceTable`` weighs its parts' sentinel keys (invalid windows) 0 before
``merge_runs``, as ``krust_tpu``'s raw windows weigh them.
:func:`merge_runs_presorted` takes the sentinel for padding, as
``krust_tpu``'s does.

Every result is as long as its input and stays on the keys' device;
``n_unique`` is a 1-element int64 tensor that is not synchronized here.
"""

from __future__ import annotations

import torch

from .keys import sentinel
from .rle import rle_compact


def _all_ones(keys: torch.Tensor, valid: torch.Tensor, weight: torch.Tensor | None):
    """Whether any valid entry lies under the sentinel key (the all-ones
    code) and the sum of their weights (their number without weights), as
    device scalars; None for an empty input."""
    if not keys.numel():
        return None
    ones = valid & (keys == sentinel(keys.dtype))
    total = ones.sum() if weight is None else torch.where(ones, weight, 0).sum()
    return ones.any(), total


def _with_all_ones(out, side):
    """K2's ``(keys, counts, n_unique)`` with the all-ones entry of
    :func:`_all_ones` at slot ``n_unique`` (its key the sentinel already)
    and ``n_unique`` one more, where there is one; no host sync."""
    if side is None:
        return out
    u_keys, u_cnt, n_unique = out
    present, total = side
    at = n_unique.clamp(max=u_cnt.numel() - 1)
    u_cnt.index_put_((at,), torch.where(present, total.to(torch.int32), u_cnt[at]))
    return u_keys, u_cnt, n_unique + present


def _sort_rle(keys: torch.Tensor, weight: torch.Tensor | None, valid: torch.Tensor,
              all_ones: bool = False):
    """Invalid entries to sentinels, keys ascending with each weight (none:
    unit weights) following its key, then K2; with ``all_ones``, the valid
    entries under the sentinel key summed on the side into the all-ones
    entry. Each temporary dies as soon as it is consumed: the sort's
    working set is the peak."""
    side = _all_ones(keys, valid, weight) if all_ones else None
    masked = torch.where(valid, keys, sentinel(keys.dtype))
    if weight is None:
        return _with_all_ones(rle_compact(torch.sort(masked).values), side)
    s_keys, order = torch.sort(masked)
    del masked
    s_weight = weight[order]
    del order
    return _with_all_ones(rle_compact(s_keys, s_weight), side)


def merge_weighted(keys: torch.Tensor, weight: torch.Tensor, valid: torch.Tensor):
    """Sum the weights of each distinct valid key, compacted to the front.

    Args:
      keys: int32 / int64 biased keys (any shape; flattened).
      weight: int32 weights, one per key.
      valid: bool; invalid entries are dropped.

    Returns:
      (u_keys, u_cnt, n_unique): the distinct valid keys ascending with their
      summed weights in the first ``n_unique`` slots (a valid key whose
      weights sum to 0 keeps its slot; a valid entry under the sentinel key
      is the all-ones code, last), sentinel keys and zero counts after.
    """
    return _sort_rle(
        keys.reshape(-1), weight.reshape(-1).to(torch.int32), valid.reshape(-1).bool(),
        all_ones=True,
    )


def count_unique(keys: torch.Tensor, valid: torch.Tensor):
    """Occurrences of each distinct valid key: :func:`merge_weighted` with
    unit weights."""
    return _sort_rle(keys.reshape(-1), None, valid.reshape(-1).bool(), all_ones=True)


def count_runs(keys: torch.Tensor, valid: torch.Tensor):
    """One batch's distinct keys and counts as a weighted part for
    :class:`~krust_tpu_torch.ops.table.DeviceTable`: (keys, counts) of the
    input's length, entries with count 0 padding. ``krust_tpu`` leaves each
    count at its run's last position to save a compaction; K2 compacts in
    the same pass, so the entries come packed to the front. A valid entry
    under the sentinel key counts as the all-ones code for int64 keys."""
    u_keys, u_cnt, _ = _sort_rle(keys.reshape(-1), None, valid.reshape(-1).bool(),
                                 all_ones=keys.dtype == torch.int64)
    return u_keys, u_cnt


def merge_runs(keys: torch.Tensor, weight: torch.Tensor):
    """Weighted merge with front compaction.

    :func:`merge_weighted` where an entry with weight 0 is padding: it
    becomes a sentinel before the sort, so a key whose weights are all 0
    takes no slot. An entry under the sentinel key with weight > 0 is the
    all-ones code for int64 keys, padding for int32 keys.
    """
    weight = weight.reshape(-1).to(torch.int32)
    return _sort_rle(keys.reshape(-1), weight, weight > 0,
                     all_ones=keys.dtype == torch.int64)


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
