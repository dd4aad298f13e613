"""Port dense codec (krust_tpu_torch.ops.codec) against the JAX package.

The same numpy-made streams are packed into dense batches by both
packages' ``pack_buffer_2bit`` (asserted byte-equal). ``krust_tpu`` runs
its dense step, ``codec.unpack_2bit`` -> ``pallas_codec.
encode_blocks_pallas`` (interpret mode) -> ``engines._sentinel_part``, and
its jnp codec ``codec.encode_blocks``; the port runs ``encode_dense_plain``.
Both emit row-major window order, so keys are compared position for
position (integer work: tolerance 0), across k, bad-base shares of 0, 5%
and 30%, all-bad padding rows and a last row that ends mid-byte.

The CUDA kernel against this plain version: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krust_tpu.io import packer as jax_packer
from krust_tpu.kmer import INVALID_CODE
from krust_tpu.models.engines import _sentinel_part
from krust_tpu.ops.codec import encode_blocks, unpack_2bit
from krust_tpu.ops.pallas_codec import encode_blocks_pallas
from krust_tpu_torch.io import packer
from krust_tpu_torch.ops.codec import encode_dense, encode_dense_plain
from krust_tpu_torch.ops.keys import key_dtype, keys_from_step, sentinel

W = 64  # windows per row: 5 real rows + 3 padding rows per batch below


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _stream(k, bad_share, seed, n_windows=4 * W + 37):
    """A stream whose last row covers 37 windows; Ns and low-quality bases
    share the bad bases."""
    rng = np.random.default_rng(seed)
    n = n_windows + k - 1
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    qual = np.full(n, ord("I"), np.uint8)
    bad = rng.random(n) < bad_share
    half = rng.random(n) < 0.5
    codes[bad & half] = INVALID_CODE
    qual[bad & ~half] = ord("#")
    return codes, qual


def _batch(codes, qual, k, batch_rows=None):
    """Both packages' dense batches, asserted byte-equal."""
    thr = ord("5")
    got = list(packer.pack_buffer_2bit(codes, qual, k, thr, W, batch_rows))
    exp = list(jax_packer.pack_buffer_2bit(codes, qual, k, thr, W, batch_rows))
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.packed2, e.packed2)
        np.testing.assert_array_equal(g.badbits, e.badbits)
        assert (g.n_windows, g.block_windows, g.width) == (
            e.n_windows, e.block_windows, e.width
        )
    return got


def _jax_keys(batch, k, pallas):
    codes = unpack_2bit(jnp.asarray(batch.packed2), jnp.asarray(batch.badbits), batch.width)
    if pallas:
        hi, lo, valid = encode_blocks_pallas(codes, k, interpret=True)
        part = _sentinel_part(hi, lo, valid, k)
    else:
        part = encode_blocks(codes, k)
    return keys_from_step(tuple(np.asarray(p) for p in part), k)


KS = [1, 2, 3, 4, 5, 8, 15, 16, 17, 21, 24, 25, 31, 32]


@pytest.mark.parametrize("bad_share", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("k", KS)
def test_dense_step_matches_pallas(k, bad_share):
    codes, qual = _stream(k, bad_share, seed=100 * k + int(100 * bad_share))
    (batch,) = _batch(codes, qual, k)
    assert batch.packed2.shape[0] == 8 and np.all(batch.badbits[5:] == 0xFF)
    got = encode_dense_plain(
        torch.from_numpy(batch.packed2), torch.from_numpy(batch.badbits), k, W
    )
    assert got.dtype == key_dtype(k) and got.shape == (8 * W,)
    assert torch.equal(got, _jax_keys(batch, k, pallas=True))
    # padding rows and windows past the stream's end are all sentinel
    tail = got[4 * W + 37 :]
    assert torch.all(tail == sentinel(got.dtype))


@pytest.mark.parametrize("k", range(1, 33))
def test_dense_step_matches_jnp_codec_all_k(k):
    codes, qual = _stream(k, 0.05, seed=7 + k)
    for batch in _batch(codes, qual, k, batch_rows=2):  # three batches
        got = encode_dense(
            torch.from_numpy(batch.packed2), torch.from_numpy(batch.badbits), k, W
        )
        assert torch.equal(got, _jax_keys(batch, k, pallas=False))


def test_all_bad_rows_are_sentinel():
    k = 21
    p2 = torch.zeros((8, -(-(W + k - 1) // 4)), dtype=torch.uint8)
    bb = torch.full((8, -(-(W + k - 1) // 8)), 0xFF, dtype=torch.uint8)
    keys = encode_dense(p2, bb, k, W)
    assert torch.all(keys == sentinel(torch.int64))


@pytest.mark.parametrize("k", [1, 3, 16, 17, 32])
def test_keys_from_step_forms_agree(k):
    """The three forms of a step output name the same keys."""
    rng = np.random.default_rng(k)
    bits = 2 * k
    codes = rng.integers(0, 1 << min(bits, 63), 300, dtype=np.uint64)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = rng.random(300) < 0.7
    raw = keys_from_step((hi, lo, valid), k)
    s_hi = np.where(valid, hi, np.uint32(0xFFFFFFFF))
    s_lo = np.where(valid, lo, np.uint32(0xFFFFFFFF))
    sent = keys_from_step((s_lo,) if k <= 16 else (s_hi, s_lo), k)
    assert torch.equal(raw, sent)
    assert torch.all(raw[torch.from_numpy(~valid)] == sentinel(key_dtype(k)))
