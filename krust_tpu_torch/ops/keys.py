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
its parts (compacted, or raw with zero-weight padding) to and from this
form, and :func:`keys_from_step` converts its per-window step output.
"""

from __future__ import annotations

import numpy as np
import torch


def key_dtype(k: int) -> torch.dtype:
    return torch.int32 if k <= 16 else torch.int64


def sentinel(dtype: torch.dtype) -> int:
    return torch.iinfo(dtype).max


def split_keys(keys: torch.Tensor, k: int, valid: torch.Tensor):
    """Keys that are codes on every window (K4's code form) and their bool
    validity plane -> ``krust_tpu``'s (hi, lo, valid) form: the code's
    uint32 halves (``hi`` 0 for k <= 16) and ``valid`` as it is. int64
    arithmetic on any device (CUDA torch has no uint32 arithmetic); uint32
    at the last step."""
    if k <= 16:  # int32 key = code - 2^31
        lo = keys.to(torch.int64) + (1 << 31)
        hi = torch.zeros_like(lo)
    else:  # int64 key = code ^ 2^63: the code's bits, bit 63 included
        code = keys ^ torch.iinfo(torch.int64).min
        hi, lo = (code >> 32) & 0xFFFFFFFF, code & 0xFFFFFFFF
    return hi.to(torch.uint32), lo.to(torch.uint32), valid


def _np_bias(k: int):
    """The key format in numpy: (unsigned view of a key, the bias, the
    signed key dtype); a key's unsigned view XOR the bias is its code."""
    if k <= 16:
        return np.uint32, np.uint32(0x80000000), np.int32
    return np.uint64, np.uint64(1 << 63), np.int64


def codes_to_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 canonical codes (all-ones = sentinel) -> biased keys."""
    udt, bias, dt = _np_bias(k)
    return (codes.astype(udt) ^ bias).view(dt)


def keys_to_codes(keys: np.ndarray, k: int) -> np.ndarray:
    """Biased keys -> uint64 codes (the inverse of :func:`codes_to_keys`)."""
    udt, bias, _ = _np_bias(k)
    return (keys.view(udt) ^ bias).astype(np.uint64, copy=False)


def parts_from_numpy(hi, lo, cnt, k: int, device=None, zero_is_padding: bool = False):
    """A ``krust_tpu`` part (uint32 hi, lo, cnt planes; hi may be None for
    k <= 16) -> (keys, int32 counts) tensors of the port.

    A compacted part carries sentinel keys in its padding already. A raw
    part (the input of ``krust_tpu.ops.count.merge_runs``, the parts of its
    ``DeviceTable``) pads with zero-weight entries under any key: with
    ``zero_is_padding`` those become sentinel keys, the port's padding.
    """
    codes = np.asarray(lo, np.uint32).reshape(-1).astype(np.uint64)
    if k > 16:
        codes |= np.asarray(hi, np.uint32).reshape(-1).astype(np.uint64) << np.uint64(32)
    cnt = np.asarray(cnt, np.uint32).reshape(-1)
    if zero_is_padding:
        codes[cnt == 0] = np.uint64(2**64 - 1)
    keys = torch.from_numpy(np.ascontiguousarray(codes_to_keys(codes, k)))
    counts = torch.from_numpy(cnt.view(np.int32).copy())
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


def parts_to_numpy(keys: torch.Tensor, counts: torch.Tensor, k: int,
                   zero_is_padding: bool = False):
    """The inverse of :func:`parts_from_numpy`: (hi, lo, cnt) uint32 planes
    (hi all zero for real k <= 16 codes, all-ones for sentinels). With
    ``zero_is_padding`` a sentinel entry becomes ``krust_tpu``'s raw
    padding, (0, 0) with weight 0."""
    kn = keys.cpu().numpy()
    codes = keys_to_codes(kn, k)
    cnt = counts.cpu().numpy().view(np.uint32)
    pad = kn == sentinel(keys.dtype)
    if k <= 16:
        hi = np.where(pad, 0xFFFFFFFF, 0).astype(np.uint32)
    else:
        hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if zero_is_padding:
        hi, lo, cnt = (np.where(pad, 0, a).astype(np.uint32) for a in (hi, lo, cnt))
    return hi, lo, cnt
