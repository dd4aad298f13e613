"""K4: dense 2-bit rows + invalid bitmask -> poisoned canonical keys; the
public codec ``encode_blocks`` on top of it.

The dense path's step. Replaces ``krust_tpu/ops/codec.py:unpack_2bit``,
the codec kernel ``krust_tpu/ops/pallas_codec.py:encode_blocks_pallas``
and the sentinel step ``krust_tpu/models/engines.py:_sentinel_part`` that
the JAX package runs in turn over a :class:`~krust_tpu_torch.io.packer.
PackedBatch2`: on the GPU the three are one kernel, ``csrc/codec.cu``,
which reads the packed bytes and the bitmask directly (no uint8 block
tensor, no valid plane). Keys come out in row-major window order as the
biased keys of :mod:`krust_tpu_torch.ops.keys`.

Bound on the H100: bytes — 0.375 B/base in, 4 B (k <= 16) or 8 B (k > 16)
per window out. The kernel is K1's tile fed from the dense layout: a block
loads its rows' packed and badbits bytes into shared memory once (16-byte
loads inside each odd-strided row, bytes at its ends), each thread keys a
run of 32 consecutive windows of one row with the window arithmetic K1 uses
(``csrc/codec_tile.cuh``), its validity bits straight from the badbits, and
the keys leave as coalesced 16-byte stores. ``csrc/codec.cu`` has the
details, and says which path serves a ``block_windows`` that is no multiple
of 32.

:func:`encode_dense` launches the CUDA kernel for CUDA tensors and runs
:func:`encode_dense_plain`, the plain PyTorch version, for CPU tensors.

The rest of ``krust_tpu/ops/codec.py``'s surface, with its signatures:
:func:`encode_blocks` (base-code rows, optional quality -> ``(hi, lo,
valid)``; on CUDA tensors the rows are packed into K4's input by a few
elementwise ops and K4 encodes them), :func:`unpack_2bit` and the host
helpers :func:`split64` / :func:`combine64`. One difference: where
``valid`` is False, ``hi`` and ``lo`` are 0 (the reference leaves the
codes of its zero substitution there; every consumer masks them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import INVALID_CODE
from . import _cuda
from .fused_codec import window_keys_plain
from .keys import key_dtype, split_keys


def unpack_2bit(packed2: torch.Tensor, badbits: torch.Tensor, width: int) -> torch.Tensor:
    """(packed2, badbits) rows -> uint8 base codes [B, width], 4 where a bit
    of badbits is set: the input :func:`encode_blocks` takes. Plain torch
    on any device (a few shifts and masks)."""
    rows = packed2.shape[0]
    shifts4 = torch.tensor([6, 4, 2, 0], dtype=torch.uint8, device=packed2.device)
    codes = ((packed2[:, :, None] >> shifts4) & 3).reshape(rows, -1)[:, :width]
    shifts8 = torch.arange(7, -1, -1, dtype=torch.uint8, device=badbits.device)
    bad = ((badbits[:, :, None] >> shifts8) & 1).reshape(rows, -1)[:, :width]
    return torch.where(bad != 0, INVALID_CODE, codes)


def _good(codes, qual, quality_threshold) -> torch.Tensor:
    """Bases that are ACGT and, when filtering, at or above the threshold."""
    good = codes < INVALID_CODE
    if qual is not None and quality_threshold is not None:
        good &= qual >= quality_threshold
    return good


def _row_keys(codes: torch.Tensor, good: torch.Tensor, k: int, n_windows: int):
    """Poisoned canonical keys of the first ``n_windows`` windows of each
    row of base codes (a window holding a base not ``good`` is the
    sentinel)."""
    bases = torch.where(good, codes, 0).to(torch.int64)
    return window_keys_plain(bases, ~good, k, n_windows)


def encode_dense_plain(
    packed2: torch.Tensor, badbits: torch.Tensor, k: int, block_windows: int
) -> torch.Tensor:
    """Plain PyTorch version of :func:`encode_dense` (same contract)."""
    codes = unpack_2bit(packed2, badbits, block_windows + k - 1)
    return _row_keys(codes, codes < INVALID_CODE, k, block_windows).reshape(-1)


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


def _check_blocks(codes, k, qual):
    if not 1 <= k <= 32:
        raise ValueError(f"encode_blocks: k={k}")
    if codes.dtype != torch.uint8 or (qual is not None and qual.dtype != torch.uint8):
        raise ValueError("encode_blocks: codes and qual must be uint8")
    if qual is not None and qual.shape != codes.shape:
        raise ValueError(f"encode_blocks: qual {tuple(qual.shape)} != codes {tuple(codes.shape)}")
    if codes.shape[-1] < k - 1:
        raise ValueError(f"encode_blocks: rows of {codes.shape[-1]} bases hold no {k}-mer")


def encode_blocks_plain(
    codes: torch.Tensor,
    k: int,
    qual: torch.Tensor | None = None,
    quality_threshold: int | None = None,
):
    """Plain PyTorch version of :func:`encode_blocks` (same contract)."""
    _check_blocks(codes, k, qual)
    keys = _row_keys(codes, _good(codes, qual, quality_threshold), k,
                     codes.shape[-1] - (k - 1))
    return split_keys(keys, k)


def pack_rows(codes, k: int, qual=None, quality_threshold=None):
    """Rows of base codes [B, W + k - 1] -> K4's input at ``block_windows``
    = W rounded up to a multiple of 4: (packed2, badbits, that width). 4
    bases a byte and 8 bad bits a byte, first base in the high bits; an
    invalid base, one below the quality threshold and the padding are bad.
    Elementwise torch on the rows' device."""
    good = _good(codes, qual, quality_threshold)
    rows, width = codes.shape
    w4 = -(-(width - (k - 1)) // 4) * 4
    p4, p8 = -(-(w4 + k - 1) // 4), -(-(w4 + k - 1) // 8)
    bases = codes.new_zeros(rows, 4 * p4)
    bases[:, :width] = torch.where(good, codes, 0)
    bad = codes.new_ones(rows, 8 * p8)
    bad[:, :width] = ~good
    shifts4 = torch.tensor([6, 4, 2, 0], dtype=torch.uint8, device=codes.device)
    shifts8 = torch.arange(7, -1, -1, dtype=torch.uint8, device=codes.device)
    packed2 = (bases.view(rows, p4, 4) << shifts4).sum(-1, dtype=torch.uint8)
    badbits = (bad.view(rows, p8, 8) << shifts8).sum(-1, dtype=torch.uint8)
    return packed2, badbits, w4


def encode_blocks(
    codes: torch.Tensor,
    k: int,
    qual: torch.Tensor | None = None,
    quality_threshold: int | None = None,
):
    """Canonical k-mer codes of haloed rows of base codes, with
    ``krust_tpu.ops.codec.encode_blocks``'s signature.

    Args:
      codes: uint8 [B, W + k - 1] base codes (0..3 valid, >= 4 invalid).
      k: 1..32.
      qual: optional uint8 [B, W + k - 1] Phred+33 quality bytes.
      quality_threshold: ASCII threshold; a base with ``qual <
        quality_threshold`` poisons every window containing it.

    Returns:
      (hi, lo, valid): uint32 [B, W], uint32 [B, W], bool [B, W]; the
      canonical code is ``hi << 32 | lo`` (``hi`` is 0 for k <= 16), and
      ``hi`` = ``lo`` = 0 where ``valid`` is False.

    CUDA tensors: the rows are packed (:func:`pack_rows`) and K4
    (:func:`encode_dense`) encodes them; CPU tensors:
    :func:`encode_blocks_plain`.
    """
    if codes.device.type == "cpu":
        return encode_blocks_plain(codes, k, qual, quality_threshold)
    _check_blocks(codes, k, qual)
    _cuda.require_cuda("encode_blocks", codes, *([] if qual is None else [qual]))
    return _encode_packed(codes, k, qual, quality_threshold)


def _encode_packed(codes, k: int, qual, quality_threshold):
    """:func:`encode_blocks` through K4: :func:`pack_rows`, then
    :func:`encode_dense` at the widened ``block_windows``, the padding
    windows sliced off, the keys split (on CPU tensors ``encode_dense``
    runs its plain version, which the tests use to hold this path)."""
    lead, width = codes.shape[:-1], codes.shape[-1]
    w = width - (k - 1)
    rows = codes.reshape(-1, width)
    if rows.shape[0] == 0 or w == 0:
        keys = torch.empty(rows.shape[0], w, dtype=key_dtype(k), device=codes.device)
    else:
        qual = None if qual is None else qual.reshape(-1, width)
        packed2, badbits, w4 = pack_rows(rows, k, qual, quality_threshold)
        keys = encode_dense(packed2, badbits, k, w4).view(-1, w4)[:, :w]
    return tuple(t.reshape(*lead, w) for t in split_keys(keys, k))


def split64(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: uint64 codes -> (hi, lo) uint32 pair."""
    codes = np.asarray(codes, dtype=np.uint64)
    return (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)


def combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host helper: (hi, lo) uint32 pair -> uint64 codes."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
