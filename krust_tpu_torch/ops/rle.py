"""K2: run-length compaction (reduce-by-key) of a key-sorted stream.

Replaces ``krust_tpu/ops/pallas_rle.py:rle_compact`` (unit, weighted and
``one_key`` modes: the key width now carries the one-key regime). The CUDA
kernel is ``csrc/rle.cu``: a head-flag pass, a scan of the heads written in
the kernel (warp shuffles, per-tile sums, a one-block scan of the tiles),
a scatter of key and weight prefix to each run's rank, and a pass that
turns prefixes into counts. The TPU kernel's sequential-grid carry in SMEM
has no counterpart: blocks run in parallel.

Bound on the H100: bytes — the keys are read twice and the distinct keys
written once; the per-tile scan is a few KB.

:func:`rle_compact` launches the kernel for CUDA tensors and runs
:func:`rle_compact_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .keys import sentinel


def rle_compact_plain(keys: torch.Tensor, cnt: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`rle_compact` (same contract)."""
    n = keys.numel()
    sent = sentinel(keys.dtype)
    valid = keys != sent
    vk = keys[valid]
    if cnt is None:
        uk, sums = torch.unique_consecutive(vk, return_counts=True)
    else:
        uk, inv = torch.unique_consecutive(vk, return_inverse=True)
        sums = torch.zeros(uk.numel(), dtype=torch.int64, device=keys.device)
        sums.index_add_(0, inv, cnt[valid].to(torch.int64))
    nu = uk.numel()
    o_keys = torch.full((n,), sent, dtype=keys.dtype, device=keys.device)
    o_keys[:nu] = uk
    o_cnt = torch.zeros(n, dtype=torch.int32, device=keys.device)
    o_cnt[:nu] = sums.to(torch.int32)
    return o_keys, o_cnt, torch.tensor([nu], dtype=torch.int64, device=keys.device)


def rle_compact(keys: torch.Tensor, cnt: torch.Tensor | None = None):
    """Distinct (key, count) table from a key-sorted sentinel-padded stream.

    Args:
      keys: int32 or int64 [n] biased keys sorted ascending, sentinels
        (the dtype's maximum) at the back.
      cnt: optional int32 [n] weights (None = every entry counts 1).

    Returns:
      (o_keys, o_cnt, n_unique): distinct keys with summed int32 counts
      packed to the front, sentinel keys / zero counts past n_unique.
      ``n_unique`` is a 1-element int64 tensor on the keys' device; it is
      not synchronized here, so the caller decides when to read it.
    """
    if keys.device.type == "cpu":
        return rle_compact_plain(keys, cnt)
    args = (keys,) if cnt is None else (keys, cnt)
    _cuda.require_cuda("rle_compact", *args)
    if keys.dtype not in (torch.int32, torch.int64) or (
        cnt is not None and (cnt.dtype != torch.int32 or cnt.shape != keys.shape)
    ):
        raise ValueError("rle_compact: int32/int64 keys, int32 counts of one shape")
    n = keys.numel()
    dev = keys.device
    lib = _cuda.library()
    n_tiles = max(-(-n // lib.krust_rle_tile()), 1)
    o_keys = torch.empty(n, dtype=keys.dtype, device=dev)
    o_cnt = torch.empty(n, dtype=torch.int32, device=dev)
    wpre = torch.empty(n, dtype=torch.int64, device=dev)
    tiles = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    totals = torch.empty(2, dtype=torch.int64, device=dev)
    fn = lib.krust_rle_i32 if keys.dtype == torch.int32 else lib.krust_rle_i64
    err = fn(
        dev.index, keys.data_ptr(), None if cnt is None else cnt.data_ptr(), n,
        o_keys.data_ptr(), o_cnt.data_ptr(), wpre.data_ptr(),
        tiles.data_ptr(), totals.data_ptr(), _cuda.stream_of(keys),
    )
    rle_compact.launches += 1
    _cuda.check("rle_compact", err)
    return o_keys, o_cnt, totals[:1]


rle_compact.launches = 0
