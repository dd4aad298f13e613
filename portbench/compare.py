"""The comparison that decides ``correct``: the program's table and
histogram against the reference's, exactly. Imports nothing of the port."""

from __future__ import annotations

import numpy as np
import torch

from .reference import BIAS


def entries_off(codes: np.ndarray, counts: np.ndarray, ref_keys: torch.Tensor,
                ref_counts: torch.Tensor) -> int:
    """How many entries the two tables do not share: the program's entries
    plus the reference's, less twice those (code, count) pairs found in
    both. 0 only when the tables are equal; a repeated code counts."""
    dev = ref_keys.device
    keys = torch.from_numpy(np.ascontiguousarray(codes, np.uint64).view(np.int64)).to(dev)
    cnt = torch.from_numpy(np.ascontiguousarray(counts, np.uint64).view(np.int64)).to(dev)
    keys, order = torch.sort(keys ^ BIAS, stable=True)
    cnt = cnt[order]
    n, m = keys.numel(), ref_keys.numel()
    if n == 0 or m == 0:
        return n + m
    at = torch.searchsorted(keys, ref_keys).clamp_(max=n - 1)
    matched = int(((keys[at] == ref_keys) & (cnt[at] == ref_counts)).sum())
    return n + m - 2 * matched


def outputs_off(outputs: list[bytes], ref: bytes) -> int:
    """How many of the program's outputs differ from the reference's bytes."""
    return sum(out != ref for out in outputs)
