"""K3: merge of two key-sorted compacted parts; K5: merge of two sorted
uint32 arrays.

Replaces ``krust_tpu/ops/pallas_merge.py:522 merge_sorted_kv`` (k > 16),
``:414 merge_sorted_lv`` (k <= 16) and ``:248 merge_sorted`` (K5, keys
only) with one CUDA template, ``csrc/merge.cu``, instantiated for int64,
int32 and unsigned uint32 keys: a merge-path tiled merge. A small launch
splits the output into tiles along merge-path diagonals (one binary search
per tile edge); then one block per tile stages its slices of both parts in
shared memory, each thread merges a few entries serially, and the block
writes the tile coalesced. Ties go to ``a`` and each side keeps its order,
so the result is the stable merge of ``cat(a, b)``: equal keys end
adjacent and no count is lost or cloned. The weighted
:func:`krust_tpu_torch.ops.rle.rle_compact` then sums them.

Bound on the H100: bytes, one read and one write of both parts; the design
reads each key from device memory once (the splits are 8 B per tile).

K5, :func:`merge_sorted_keys`, is the instantiation without a payload, for
uint32 keys compared unsigned. No counting path calls it.

:func:`merge_sorted` and :func:`merge_sorted_keys` launch the kernels for
CUDA tensors (both launches count as one on the wrapper's counter) and run
:func:`merge_sorted_plain` / :func:`merge_sorted_keys_plain` for CPU
tensors.
"""

from __future__ import annotations

import torch

from . import _cuda


def _splits(lib, total: int, keys: torch.Tensor) -> torch.Tensor:
    """The merge-path splits: one int64 per tile edge of the output."""
    tile = lib.krust_merge_tile(keys.element_size())
    return torch.empty(-(-total // tile) + 1, dtype=torch.int64, device=keys.device)


def merge_sorted_plain(a_keys, a_cnt, b_keys, b_cnt):
    """Plain PyTorch version of :func:`merge_sorted`: ``cat`` + stable sort."""
    keys = torch.cat([a_keys, b_keys])
    order = torch.sort(keys, stable=True).indices
    return keys[order], torch.cat([a_cnt, b_cnt])[order]


def merge_sorted(a_keys, a_cnt, b_keys, b_cnt):
    """Merge two key-sorted (keys, int32 counts) parts into one sorted part.

    Keys are int32 or int64 biased keys (both parts one dtype), sentinels
    as ordinary maximal keys; lengths may differ. Equal keys keep a-before-b
    order. Returns (keys, counts) of length ``len(a) + len(b)``. Parts of
    two key dtypes, or counts that are not int32 of their keys' shape,
    raise ``ValueError`` on every device.
    """
    if (
        a_keys.dtype != b_keys.dtype
        or a_keys.dtype not in (torch.int32, torch.int64)
        or a_cnt.dtype != torch.int32
        or b_cnt.dtype != torch.int32
        or a_cnt.shape != a_keys.shape
        or b_cnt.shape != b_keys.shape
    ):
        raise ValueError("merge_sorted: one key dtype, int32 counts per key")
    if a_keys.device.type == "cpu":
        return merge_sorted_plain(a_keys, a_cnt, b_keys, b_cnt)
    _cuda.require_cuda("merge_sorted", a_keys, a_cnt, b_keys, b_cnt)
    ma, mb = a_keys.numel(), b_keys.numel()
    out_keys = torch.empty(ma + mb, dtype=a_keys.dtype, device=a_keys.device)
    out_cnt = torch.empty(ma + mb, dtype=torch.int32, device=a_keys.device)
    lib = _cuda.library()
    fn = lib.krust_merge_i32 if a_keys.dtype == torch.int32 else lib.krust_merge_i64
    splits = _splits(lib, ma + mb, a_keys)
    err = fn(
        a_keys.device.index, a_keys.data_ptr(), a_cnt.data_ptr(), ma,
        b_keys.data_ptr(), b_cnt.data_ptr(), mb,
        out_keys.data_ptr(), out_cnt.data_ptr(), splits.data_ptr(),
        _cuda.stream_of(a_keys),
    )
    merge_sorted.launches += 1
    _cuda.check("merge_sorted", err)
    return out_keys, out_cnt


merge_sorted.launches = 0


def widen_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> int64 of the same value, through an int32 view (CUDA
    PyTorch has few kernels for uint32 itself)."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def merge_sorted_keys_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`merge_sorted_keys`: ``cat`` + sort,
    in int64, where signed order is the keys' unsigned order."""
    keys = torch.sort(torch.cat([widen_u32(a), widen_u32(b)])).values
    return keys.to(torch.int32).view(torch.uint32)


def merge_sorted_keys(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge two equal-length sorted uint32 arrays into one of length 2m.

    ``0xFFFFFFFF`` padding is an ordinary maximal key; keys compare
    unsigned. Unequal shapes raise ``ValueError``.
    """
    if a.shape != b.shape:
        raise ValueError(f"inputs must have equal shape, got {a.shape} vs {b.shape}")
    if a.device.type == "cpu":
        return merge_sorted_keys_plain(a, b)
    _cuda.require_cuda("merge_sorted_keys", a, b)
    if a.dtype != torch.uint32 or b.dtype != torch.uint32 or a.dim() != 1:
        raise ValueError("merge_sorted_keys: one-dimensional uint32 keys")
    m = a.numel()
    out = torch.empty(2 * m, dtype=torch.uint32, device=a.device)
    lib = _cuda.library()
    splits = _splits(lib, 2 * m, a)
    err = lib.krust_merge_keys_u32(
        a.device.index, a.data_ptr(), b.data_ptr(), m, out.data_ptr(), splits.data_ptr(),
        _cuda.stream_of(a),
    )
    merge_sorted_keys.launches += 1
    _cuda.check("merge_sorted_keys", err)
    return out


merge_sorted_keys.launches = 0
