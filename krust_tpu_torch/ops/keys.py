"""Key representation of the port's counting core.

A canonical k-mer code ``c`` (2k bits, unsigned) is stored as one signed
key, biased so that signed order equals unsigned order:

- k <= 16: int32 ``c ^ 0x80000000`` (the TPU engine's one-key regime, half
  the bytes of a 64-bit key through the sort, RLE and merge);
- k > 16: int64 ``c ^ 2^63``. Canonical 32-mers can have bit 63 set, so an
  unbiased int64 sort would misorder them.

The invalid-window sentinel is the all-ones code — the all-T k-mer, never
canonical since its reverse complement is all-A — which the bias turns into
the dtype's maximum, so sentinels sort last. The TPU engine's (hi, lo)
uint32 lane pairs and plane-separated window order are TPU layout devices
the port drops; :func:`parts_from_numpy` / :func:`parts_to_numpy` convert
its compacted parts to and from this form, and :func:`keys_from_step`
converts its per-window step output.
"""

from __future__ import annotations

import numpy as np
import torch


def key_dtype(k: int) -> torch.dtype:
    return torch.int32 if k <= 16 else torch.int64


def sentinel(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def _np_bias(k: int):
    return (np.uint32(0x80000000), np.int32) if k <= 16 else (
        np.uint64(1 << 63), np.int64
    )


def codes_to_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 canonical codes (all-ones = sentinel) -> biased keys."""
    bias, dt = _np_bias(k)
    udt = np.uint32 if k <= 16 else np.uint64
    return (codes.astype(udt) ^ bias).view(dt)


def keys_to_codes(keys: np.ndarray, k: int) -> np.ndarray:
    """Biased keys -> uint64 codes (the inverse of :func:`codes_to_keys`)."""
    bias, _ = _np_bias(k)
    udt = np.uint32 if k <= 16 else np.uint64
    return (keys.view(udt) ^ bias).astype(np.uint64)


def parts_from_numpy(hi, lo, cnt, k: int, device=None):
    """A ``krust_tpu`` compacted part (uint32 hi, lo, cnt planes; hi may be
    None for k <= 16) -> (keys, int32 counts) tensors of the port."""
    codes = np.asarray(lo, np.uint32).astype(np.uint64)
    if k > 16:
        codes |= np.asarray(hi, np.uint32).astype(np.uint64) << np.uint64(32)
    keys = torch.from_numpy(np.ascontiguousarray(codes_to_keys(codes, k)))
    counts = torch.from_numpy(np.asarray(cnt, np.uint32).view(np.int32).copy())
    return keys.to(device), counts.to(device)


def keys_from_step(part, k: int) -> torch.Tensor:
    """A ``krust_tpu`` per-window step output -> the port's keys, position
    for position.

    ``part`` is the sentinel part ``(lo,)`` (k <= 16) or ``(hi, lo)`` of
    ``_sentinel_part``, invalid windows already (SENT, SENT), or the raw
    ``(hi, lo, valid)``; uint32 planes (valid: any integer or bool).
    """
    hi, lo, valid = (None, part[0], None) if len(part) == 1 else (*part, None)[:3]
    codes = np.asarray(lo, np.uint32).reshape(-1).astype(np.uint64)
    if hi is not None:
        codes |= np.asarray(hi, np.uint32).reshape(-1).astype(np.uint64) << np.uint64(32)
    if valid is not None:
        codes[np.asarray(valid).reshape(-1) == 0] = np.uint64(2**64 - 1)
    return torch.from_numpy(np.ascontiguousarray(codes_to_keys(codes, k)))


def parts_to_numpy(keys: torch.Tensor, counts: torch.Tensor, k: int):
    """The inverse of :func:`parts_from_numpy`: (hi, lo, cnt) uint32 planes
    (hi all zero for real k <= 16 codes, all-ones for sentinels)."""
    kn = keys.cpu().numpy()
    codes = keys_to_codes(kn, k)
    if k <= 16:
        hi = np.where(kn == sentinel(keys.dtype), 0xFFFFFFFF, 0).astype(np.uint32)
    else:
        hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo, counts.cpu().numpy().view(np.uint32)
