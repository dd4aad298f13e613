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

K4 has a second output form, the code form (``encode_dense(...,
codes=True)``): every window's canonical code with ``krust_tpu``'s
substitution for a bad base (code 0 on both strands) and no sentinel, and
each run of 32 windows' poison bits as one word. It serves the rest of
``krust_tpu/ops/codec.py``'s surface, with its signatures:
:func:`encode_blocks` (base-code rows, optional quality -> ``(hi, lo,
valid)``, equal to ``krust_tpu``'s on every window; on CUDA tensors the
rows are packed into K4's input by a few elementwise ops and K4's code
form encodes them), :func:`unpack_2bit` and the host helpers
:func:`split64` / :func:`combine64`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import INVALID_CODE
from . import _cuda
from .fused_codec import window_codes_plain
from .keys import key_dtype, sentinel, split_keys


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


def _row_codes(codes, good, k: int, n_windows: int):
    """(keys, poisoned) of the first ``n_windows`` windows of each row of
    base codes, ``krust_tpu``'s substitution in the keys (a base not
    ``good`` is 0 on both strands), no sentinel."""
    bases = torch.where(good, codes, 0).to(torch.int64)
    return window_codes_plain(bases, ~good, k, n_windows)


def poison_words(poisoned: torch.Tensor) -> torch.Tensor:
    """A bool plane [rows, w] -> the code form's poison plane, int32 [rows,
    ceil(w / 32)]: bit r of word (row, run) set where window 32 run + r is
    poisoned or lies past w."""
    rows, w = poisoned.shape
    runs = -(-w // 32)
    bits = torch.nn.functional.pad(poisoned, (0, 32 * runs - w), value=True)
    shifts = torch.arange(32, dtype=torch.int64, device=poisoned.device)
    words = (bits.view(rows, runs, 32).to(torch.int64) << shifts).sum(-1)
    return (words - ((words >> 31) << 32)).to(torch.int32)  # as int32 bits


def valid_of(poison: torch.Tensor, w: int) -> torch.Tensor:
    """The code form's poison plane, int32 [rows, runs] -> valid, bool
    [rows, w]: the inverse of :func:`poison_words`. Elementwise torch on
    the plane's device."""
    shifts = torch.arange(32, dtype=torch.int32, device=poison.device)
    bits = (poison[:, :, None] >> shifts) & 1
    return (bits == 0).reshape(poison.shape[0], -1)[:, :w]


def encode_dense_plain(
    packed2: torch.Tensor, badbits: torch.Tensor, k: int, block_windows: int,
    *, codes: bool = False,
):
    """Plain PyTorch version of :func:`encode_dense` (same contract, both
    forms)."""
    bases = unpack_2bit(packed2, badbits, block_windows + k - 1)
    keys, poisoned = _row_codes(bases, bases < INVALID_CODE, k, block_windows)
    if codes:
        return keys.reshape(-1), poison_words(poisoned)
    return keys.masked_fill_(poisoned, sentinel(keys.dtype)).reshape(-1)


def encode_dense(
    packed2: torch.Tensor, badbits: torch.Tensor, k: int, block_windows: int,
    *, codes: bool = False,
):
    """Poisoned canonical keys of every window of a dense batch (the
    counting form), or with ``codes`` every window's code and the poison
    bits (the code form, :func:`encode_blocks`' step).

    Args:
      packed2: uint8 [rows, ceil((W + k - 1) / 4)]: each row's bases, 4 per
        byte, first base in the high bits (``W = block_windows``).
      badbits: uint8 [rows, ceil((W + k - 1) / 8)]: each row's invalid
        bases, 8 per byte, first base in bit 7; padding is bad.
      k: 1..32. ``block_windows``: a multiple of 4.

    Returns:
      keys [rows * W] (int32 for k <= 16, int64 otherwise), row-major
      window order; a window holding a bad base is the sentinel. With
      ``codes``: (keys, poison), the keys of every window with a bad base
      taken as code 0 on both strands (``krust_tpu``'s substitution, no
      sentinel) and int32 [rows, ceil(W / 32)] poison words, bit r of word
      (row, run) set where window 32 run + r holds a bad base or lies past
      W (:func:`valid_of` widens them).
    """
    if packed2.device.type == "cpu":
        return encode_dense_plain(packed2, badbits, k, block_windows, codes=codes)
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
    args = (packed2.device.index, packed2.data_ptr(), badbits.data_ptr(), rows, p4, p8,
            k, block_windows, out.data_ptr())
    if codes:
        poison = torch.empty(rows, -(-block_windows // 32), dtype=torch.int32,
                             device=packed2.device)
        fn = lib.krust_encode_codes_i32 if dt == torch.int32 else lib.krust_encode_codes_i64
        err = fn(*args, poison.data_ptr(), _cuda.stream_of(packed2))
    else:
        fn = lib.krust_encode_dense_i32 if dt == torch.int32 else lib.krust_encode_dense_i64
        err = fn(*args, _cuda.stream_of(packed2))
    encode_dense.launches += 1
    _cuda.check("encode_dense", err)
    return (out, poison) if codes else out


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
    keys, poisoned = _row_codes(codes, _good(codes, qual, quality_threshold), k,
                                codes.shape[-1] - (k - 1))
    return split_keys(keys, k, ~poisoned)


def pack_rows(codes, k: int, qual=None, quality_threshold=None):
    """Rows of base codes [B, W + k - 1] -> K4's input at ``block_windows``
    = W rounded up to a multiple of 4: (packed2, badbits, that width). 4
    bases a byte and 8 bad bits a byte, first base in the high bits; an
    invalid base, one below the quality threshold and the padding are bad,
    and each is packed as code 0 (``krust_tpu``'s substitution; K4's code
    form masks bad bases itself as well). Elementwise torch on the rows'
    device."""
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
      canonical code is ``hi << 32 | lo`` (``hi`` is 0 for k <= 16). Where
      ``valid`` is False it is ``krust_tpu``'s: the canonical code of the
      window with every bad base taken as code 0 on both strands.

    CUDA tensors: the rows are packed (:func:`pack_rows`) and K4's code
    form (:func:`encode_dense` with ``codes``) encodes them; CPU tensors:
    :func:`encode_blocks_plain`.
    """
    if codes.device.type == "cpu":
        return encode_blocks_plain(codes, k, qual, quality_threshold)
    _check_blocks(codes, k, qual)
    _cuda.require_cuda("encode_blocks", codes, *([] if qual is None else [qual]))
    return _encode_packed(codes, k, qual, quality_threshold)


def _encode_packed(codes, k: int, qual, quality_threshold):
    """:func:`encode_blocks` through K4: :func:`pack_rows`, then
    :func:`encode_dense`'s code form at the widened ``block_windows`` (one
    launch), the padding windows sliced off, the keys split with the
    widened poison plane (on CPU tensors ``encode_dense`` runs its plain
    version, which the tests use to hold this path)."""
    lead, width = codes.shape[:-1], codes.shape[-1]
    w = width - (k - 1)
    rows = codes.reshape(-1, width)
    if rows.shape[0] == 0 or w == 0:
        keys = torch.empty(rows.shape[0], w, dtype=key_dtype(k), device=codes.device)
        valid = torch.ones(keys.shape, dtype=torch.bool, device=codes.device)
    else:
        qual = None if qual is None else qual.reshape(-1, width)
        packed2, badbits, w4 = pack_rows(rows, k, qual, quality_threshold)
        keys, poison = encode_dense(packed2, badbits, k, w4, codes=True)
        keys, valid = keys.view(-1, w4)[:, :w], valid_of(poison, w)
    return tuple(t.reshape(*lead, w) for t in split_keys(keys, k, valid))


def split64(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: uint64 codes -> (hi, lo) uint32 pair."""
    codes = np.asarray(codes, dtype=np.uint64)
    return (codes >> np.uint64(32)).astype(np.uint32), codes.astype(np.uint32)


def combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Host helper: (hi, lo) uint32 pair -> uint64 codes."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
