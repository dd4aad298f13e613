"""K3: merge of two key-sorted compacted parts.

Replaces ``krust_tpu/ops/pallas_merge.py:merge_sorted_kv`` (k > 16) and
``merge_sorted_lv`` (k <= 16) with one CUDA kernel templated on the key
width, ``csrc/merge.cu``: a rank-scatter merge (each entry's slot is its
index plus its rank in the other part), stable with a-before-b ties, so
equal keys end adjacent and no count is lost or cloned. The weighted
:func:`krust_tpu_torch.ops.rle.rle_compact` then sums them.

Bound on the H100: the binary searches' dependent loads; one read and one
write of both parts otherwise. A merge-path tiled merge is later work.

:func:`merge_sorted` launches the kernel for CUDA tensors and runs
:func:`merge_sorted_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda


def merge_sorted_plain(a_keys, a_cnt, b_keys, b_cnt):
    """Plain PyTorch version of :func:`merge_sorted`: ``cat`` + stable sort."""
    keys = torch.cat([a_keys, b_keys])
    order = torch.sort(keys, stable=True).indices
    return keys[order], torch.cat([a_cnt, b_cnt])[order]


def merge_sorted(a_keys, a_cnt, b_keys, b_cnt):
    """Merge two key-sorted (keys, int32 counts) parts into one sorted part.

    Keys are int32 or int64 biased keys (both parts one dtype), sentinels
    as ordinary maximal keys; lengths may differ. Equal keys keep a-before-b
    order. Returns (keys, counts) of length ``len(a) + len(b)``.
    """
    if a_keys.device.type == "cpu":
        return merge_sorted_plain(a_keys, a_cnt, b_keys, b_cnt)
    _cuda.require_cuda("merge_sorted", a_keys, a_cnt, b_keys, b_cnt)
    if (
        a_keys.dtype != b_keys.dtype
        or a_keys.dtype not in (torch.int32, torch.int64)
        or a_cnt.dtype != torch.int32
        or b_cnt.dtype != torch.int32
        or a_cnt.shape != a_keys.shape
        or b_cnt.shape != b_keys.shape
    ):
        raise ValueError("merge_sorted: one key dtype, int32 counts per key")
    ma, mb = a_keys.numel(), b_keys.numel()
    out_keys = torch.empty(ma + mb, dtype=a_keys.dtype, device=a_keys.device)
    out_cnt = torch.empty(ma + mb, dtype=torch.int32, device=a_keys.device)
    lib = _cuda.library()
    fn = lib.krust_merge_i32 if a_keys.dtype == torch.int32 else lib.krust_merge_i64
    err = fn(
        a_keys.device.index, a_keys.data_ptr(), a_cnt.data_ptr(), ma,
        b_keys.data_ptr(), b_cnt.data_ptr(), mb,
        out_keys.data_ptr(), out_cnt.data_ptr(), _cuda.stream_of(a_keys),
    )
    merge_sorted.launches += 1
    _cuda.check("merge_sorted", err)
    return out_keys, out_cnt


merge_sorted.launches = 0
