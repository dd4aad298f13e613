"""K4: dense 2-bit rows + invalid bitmask -> poisoned canonical keys.

The dense path's step. Replaces ``krust_tpu/ops/codec.py:unpack_2bit``,
the codec kernel ``krust_tpu/ops/pallas_codec.py:encode_blocks_pallas``
and the sentinel step ``krust_tpu/models/engines.py:_sentinel_part`` that
the JAX package runs in turn over a :class:`~krust_tpu_torch.io.packer.
PackedBatch2`: on the GPU the three are one kernel, ``csrc/codec.cu``,
which reads the packed bytes and the bitmask directly (no uint8 block
tensor, no valid plane). Keys come out in row-major window order as the
biased keys of :mod:`krust_tpu_torch.ops.keys`.

Bound on the H100: bytes — 0.375 B/base in, 4 B (k <= 16) or 8 B (k > 16)
per window out. The kernel source says what its design does about it.

:func:`encode_dense` launches the CUDA kernel for CUDA tensors and runs
:func:`encode_dense_plain`, the plain PyTorch version, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fused_codec import window_keys_plain
from .keys import key_dtype


def encode_dense_plain(
    packed2: torch.Tensor, badbits: torch.Tensor, k: int, block_windows: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`encode_dense` (same contract)."""
    width = block_windows + k - 1
    rows = packed2.shape[0]
    shifts4 = torch.tensor([6, 4, 2, 0], dtype=torch.int64, device=packed2.device)
    bases = (packed2.to(torch.int64)[:, :, None] >> shifts4) & 3
    bases = bases.reshape(rows, 4 * packed2.shape[1])[:, :width]
    shifts8 = torch.arange(7, -1, -1, dtype=torch.int64, device=badbits.device)
    bad = (badbits.to(torch.int64)[:, :, None] >> shifts8) & 1
    bad = bad.reshape(rows, 8 * badbits.shape[1])[:, :width].bool()
    return window_keys_plain(bases, bad, k, block_windows).reshape(-1)


def encode_dense(
    packed2: torch.Tensor, badbits: torch.Tensor, k: int, block_windows: int
) -> torch.Tensor:
    """Poisoned canonical keys of every window of a dense batch.

    Args:
      packed2: uint8 [rows, ceil((W + k - 1) / 4)]: each row's bases, 4 per
        byte, first base in the high bits (``W = block_windows``).
      badbits: uint8 [rows, ceil((W + k - 1) / 8)]: each row's invalid
        bases, 8 per byte, first base in bit 7; padding is bad.
      k: 1..32. ``block_windows``: a multiple of 4.

    Returns:
      keys [rows * W] (int32 for k <= 16, int64 otherwise), row-major
      window order; a window holding a bad base is the sentinel.
    """
    if packed2.device.type == "cpu":
        return encode_dense_plain(packed2, badbits, k, block_windows)
    _cuda.require_cuda("encode_dense", packed2, badbits)
    width = block_windows + k - 1
    p4, p8 = -(-width // 4), -(-width // 8)  # packed2 / badbits bytes per row
    rows = packed2.shape[0]
    if packed2.dtype != torch.uint8 or badbits.dtype != torch.uint8:
        raise ValueError("encode_dense: packed2 and badbits must be uint8")
    if not 1 <= k <= 32 or block_windows <= 0 or block_windows % 4:
        raise ValueError(f"encode_dense: k={k}, block_windows={block_windows}")
    if packed2.shape != (rows, p4) or badbits.shape != (rows, p8):
        raise ValueError(
            f"encode_dense: packed2 {tuple(packed2.shape)} / badbits "
            f"{tuple(badbits.shape)}, expected [{rows}, {p4}] / [{rows}, {p8}]"
        )
    dt = key_dtype(k)
    out = torch.empty(rows * block_windows, dtype=dt, device=packed2.device)
    lib = _cuda.library()
    fn = lib.krust_encode_dense_i32 if dt == torch.int32 else lib.krust_encode_dense_i64
    err = fn(
        packed2.device.index, packed2.data_ptr(), badbits.data_ptr(), rows, p4, p8,
        k, block_windows, out.data_ptr(), _cuda.stream_of(packed2),
    )
    encode_dense.launches += 1
    _cuda.check("encode_dense", err)
    return out


encode_dense.launches = 0
