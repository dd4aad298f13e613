"""K1: packed 2-bit bases -> poisoned canonical keys, one per window.

Replaces ``krust_tpu/ops/pallas_fused.py:encode_packed_pallas`` and the
window poisoning ``krust_tpu/models/engines.py:_count_flat_step`` does
around it (invalid-position scatter, log-step dilation, covered mask,
sentinel where): on the GPU both are one kernel,
``csrc/fused_codec.cu``. Keys come out in window order (the TPU kernel's
plane-separated order was a lane-layout device) as the biased keys of
:mod:`krust_tpu_torch.ops.keys`.

Bound on the H100: bytes — 0.25 B/base in, 4 B (k <= 16) or 8 B (k > 16)
per window out. The kernel is tiled for it: one block per 4096 windows
loads the tile's packed bytes with 16-byte loads, finds the tile's slice of
``invpos`` with one warp-wide search per end and sets it in a shared
bad-base bitmask (a window is bad iff its k bits hold a 1), keys 32
consecutive windows per thread with no serial dependency between them, and
writes the keys out as coalesced 16-byte stores. ``csrc/fused_codec.cu``
has the details.

:func:`encode_windows` launches the CUDA kernel for CUDA tensors and runs
:func:`encode_windows_plain`, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .keys import key_dtype, sentinel

#: bytes past n_windows / 4 the kernel may read (the halo of the last
#: tile's last windows)
TAIL_BYTES = 8


def unpack_2bit(packed: torch.Tensor, n_bases: int) -> torch.Tensor:
    """uint8 bytes (4 bases each, first base in the high bits) -> int64
    base codes [n_bases]."""
    shifts = torch.tensor([6, 4, 2, 0], dtype=torch.int64, device=packed.device)
    nbytes = -(-n_bases // 4)
    b = packed[:nbytes].to(torch.int64)
    return ((b[:, None] >> shifts) & 3).reshape(-1)[:n_bases]


def window_keys_plain(
    bases: torch.Tensor, bad: torch.Tensor, k: int, n_windows: int
) -> torch.Tensor:
    """Canonical keys of the first ``n_windows`` windows along the last axis.

    ``bases`` int64 [..., >= n_windows + k - 1] codes 0..3, ``bad`` bool of
    the same shape; leading axes (the rows of a dense batch) are
    independent. A window holding a bad base gets the sentinel key. An
    int64 k-step shift/or over all windows; int64 arithmetic throughout
    (CPU torch has no ``<<`` or ``minimum`` on unsigned dtypes).
    """
    fwd = torch.zeros(
        bases.shape[:-1] + (n_windows,), dtype=torch.int64, device=bases.device
    )
    rc = torch.zeros_like(fwd)
    for i in range(k):
        b = bases[..., i : i + n_windows]
        fwd = (fwd << 2) | b
        rc = rc | ((3 - b) << (2 * i))
    cb = torch.nn.functional.pad(bad.to(torch.int32).cumsum(-1), (1, 0))
    poisoned = (cb[..., k : k + n_windows] - cb[..., :n_windows]) > 0
    dt = key_dtype(k)
    if k <= 16:  # codes < 2^32: plain int64 min, then the 2^31 bias
        keys = torch.minimum(fwd, rc) - (1 << 31)
    else:  # bit 63 may be set (k = 32): compare biased
        bias = torch.iinfo(torch.int64).min
        keys = torch.minimum(fwd ^ bias, rc ^ bias)
    keys = keys.to(dt)
    return keys.masked_fill_(poisoned, sentinel(dt))


def encode_windows_plain(
    packed: torch.Tensor,
    invpos: torch.Tensor,
    covered: int,
    k: int,
    n_windows: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`encode_windows` (same contract)."""
    n_bases = n_windows + k - 1
    bases = unpack_2bit(packed, n_bases)
    bad = torch.zeros(n_bases + 1, dtype=torch.bool, device=packed.device)
    pos = invpos.to(torch.int64).clamp(max=n_bases)  # padding -> spill slot
    bad[pos] = True
    keys = window_keys_plain(bases, bad[:n_bases], k, n_windows)
    keys[max(covered, 0) :] = sentinel(keys.dtype)
    return keys


def encode_windows(
    packed: torch.Tensor,
    invpos: torch.Tensor,
    covered: int,
    k: int,
    n_windows: int,
) -> torch.Tensor:
    """Poisoned canonical keys of windows ``[0, n_windows)`` of a stream slice.

    Args:
      packed: uint8, >= ``n_windows / 4 + TAIL_BYTES`` bytes: the slice's
        bases, 4 per byte, first base in the high bits.
      invpos: int32, sorted: positions of invalid bases in the slice
        (padding values >= ``n_windows + k - 1`` poison nothing).
      covered: windows at index >= covered are padding.
      k: 1..32. ``n_windows``: a multiple of 4.

    Returns:
      keys [n_windows] (int32 for k <= 16, int64 otherwise), window order;
      a window past ``covered`` or holding an invalid base is the sentinel.
    """
    if packed.device.type == "cpu":
        return encode_windows_plain(packed, invpos, covered, k, n_windows)
    _cuda.require_cuda("encode_windows", packed, invpos)
    if packed.dtype != torch.uint8 or invpos.dtype != torch.int32:
        raise ValueError("encode_windows: packed must be uint8, invpos int32")
    if not 1 <= k <= 32 or n_windows % 4:
        raise ValueError(f"encode_windows: k={k}, n_windows={n_windows}")
    if packed.numel() < n_windows // 4 + TAIL_BYTES:
        raise ValueError("encode_windows: packed input too short")
    dt = key_dtype(k)
    out = torch.empty(n_windows, dtype=dt, device=packed.device)
    lib = _cuda.library()
    fn = lib.krust_encode_windows_i32 if dt == torch.int32 else lib.krust_encode_windows_i64
    err = fn(
        packed.device.index, packed.data_ptr(), invpos.data_ptr(), invpos.numel(), covered, k,
        n_windows, out.data_ptr(), _cuda.stream_of(packed),
    )
    encode_windows.launches += 1
    _cuda.check("encode_windows", err)
    return out


encode_windows.launches = 0
