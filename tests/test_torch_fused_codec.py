"""Port codec (krust_tpu_torch.ops.fused_codec) against the JAX package.

The port's codec emits one biased key per window in window order, with
window poisoning inside; ``krust_tpu``'s fused Pallas kernel emits
plane-separated (hi, lo) planes and poisons outside. These tests feed both
the same numpy-made inputs and compare exactly (integer work: tolerance 0):

- kernel level: the port's plain codec against ``encode_packed_pallas``
  (interpret mode) through ``plane_permute``, on clean streams;
- step level: the port's poisoned step against ``_count_flat_step(fused=
  True, mode="raw_sent")`` (interpret mode) as multisets, on dirty streams.

The CUDA kernel against this plain version: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krust_tpu.io.packer import pack2_full
from krust_tpu.kmer import INVALID_CODE
from krust_tpu.models.engines import _count_flat_step as jax_flat_step
from krust_tpu.ops.pallas_fused import HALO_BYTES, encode_packed_pallas, plane_permute
from krust_tpu_torch.ops.fused_codec import TAIL_BYTES, encode_windows
from krust_tpu_torch.ops.keys import keys_to_codes, sentinel


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _port_packed(packed: np.ndarray, rows: int, w: int) -> torch.Tensor:
    out = np.zeros(rows * w // 4 + TAIL_BYTES, np.uint8)
    m = min(out.shape[0], packed.shape[0])
    out[:m] = packed[:m]
    return torch.from_numpy(out)


def _kernel_parity(k: int, rows: int = 8, w: int = 512, seed: int = 0):
    rng = np.random.default_rng(seed + k)
    w4 = w // 4
    n = rows * w + k - 1
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    packed = pack2_full(codes)
    padded = np.concatenate([packed, np.zeros((rows + 1) * w4 - packed.shape[0], np.uint8)])
    main = jnp.asarray(padded[: rows * w4].reshape(rows, w4))
    halo = jnp.asarray(padded[w4:].reshape(rows, w4)[:, :HALO_BYTES])
    hi, lo = encode_packed_pallas(main, halo, k, interpret=True)
    exp = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo)

    invpos = torch.full((8,), n, dtype=torch.int32)  # padding only
    keys = encode_windows(_port_packed(packed, rows, w), invpos, rows * w, k, rows * w)
    got = keys_to_codes(keys.numpy(), k).reshape(rows, w)
    np.testing.assert_array_equal(plane_permute(got), exp)  # numpy: no x64 cut


@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 21, 24, 32])
def test_plain_codec_matches_pallas(k):
    _kernel_parity(k)


@pytest.mark.slow
@pytest.mark.parametrize("k", [2, 4, 7, 8, 11, 13, 15, 19, 20, 23, 25, 29, 31])
def test_plain_codec_matches_pallas_all_k(k):
    _kernel_parity(k, seed=100)


def _flat_batch(stream: np.ndarray, k: int, rows: int, w: int):
    """One FlatBatch-shaped (packed2, invpos, covered), as the packer makes it."""
    seg_bases = rows * w + k - 1
    if stream.shape[0] < seg_bases:
        stream = np.concatenate([stream, np.zeros(seg_bases - stream.shape[0], np.uint8)])
    covered = min(rows * w, stream.shape[0] - k + 1)
    packed2 = pack2_full(stream)
    inv = np.flatnonzero(stream >= INVALID_CODE).astype(np.int32)
    p = max(8, int(2 ** np.ceil(np.log2(max(inv.shape[0], 1)))))
    invpos = np.full(p, seg_bases, np.int32)
    invpos[: inv.shape[0]] = inv
    return packed2, invpos, covered


def _jax_codes(packed2, invpos, covered, k, rows, w):
    out = jax_flat_step(
        jnp.asarray(packed2), jnp.asarray(invpos), np.int32(covered),
        k, rows, w, False, "raw_sent", True, True,
    )
    if len(out) == 1:  # lo-only part (k <= 16)
        return np.sort(np.asarray(out[0]).astype(np.uint64))
    return np.sort(
        (np.asarray(out[0]).astype(np.uint64) << np.uint64(32))
        | np.asarray(out[1]).astype(np.uint64)
    )


def _port_keys(packed2, invpos, covered, k, rows, w):
    """The port's flat step: what BatchEngine runs per batch."""
    return encode_windows(
        _port_packed(packed2, rows, w), torch.from_numpy(invpos), covered, k, rows * w
    )


@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 21, 24, 32])
def test_poisoned_step_matches_jax_fused_step(k):
    """Dirty stream (Ns + separators) and a ragged covered tail: the same
    multiset of sentinel-or-canonical keys as the JAX fused step."""
    rng = np.random.default_rng(7 + k)
    rows, w = 8, 512
    stream = rng.integers(0, 4, size=rows * w - 300, dtype=np.uint8)
    if k == 32:
        stream[:200] = 2  # G-runs: canonical 32-mers with bit 63 set
    bad = rng.choice(stream.shape[0], size=25, replace=False)
    stream[bad] = INVALID_CODE
    args = _flat_batch(stream, k, rows, w) + (k, rows, w)
    got = np.sort(keys_to_codes(_port_keys(*args).numpy(), k))
    np.testing.assert_array_equal(got, _jax_codes(*args))


def test_covered_mask():
    """Windows at index >= covered are sentinel-keyed."""
    k, rows, w = 21, 8, 512
    rng = np.random.default_rng(3)
    stream = rng.integers(0, 4, size=rows * w + k - 1, dtype=np.uint8)
    packed2, invpos, _ = _flat_batch(stream, k, rows, w)
    keys = _port_keys(packed2, invpos, 100, k, rows, w)
    assert int((keys != sentinel(keys.dtype)).sum()) == 100
    assert bool((keys[100:] == sentinel(keys.dtype)).all())


def test_one_invalid_base_poisons_k_windows():
    k, rows, w = 7, 8, 512
    stream = np.zeros(rows * w + k - 1, np.uint8)  # poly-A
    stream[1000] = INVALID_CODE
    packed2, invpos, covered = _flat_batch(stream, k, rows, w)
    keys = _port_keys(packed2, invpos, covered, k, rows, w)
    bad = np.flatnonzero(keys.numpy() == sentinel(keys.dtype))
    np.testing.assert_array_equal(bad, np.arange(1000 - k + 1, 1001))


def test_key_dtype_by_k():
    invpos = torch.full((8,), 1 << 20, dtype=torch.int32)
    packed = torch.zeros(64 + TAIL_BYTES, dtype=torch.uint8)
    assert encode_windows(packed, invpos, 256, 16, 256).dtype == torch.int32
    assert encode_windows(packed, invpos, 256, 17, 256).dtype == torch.int64

