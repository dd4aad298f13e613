"""Port dense codec (krust_tpu_torch.ops.codec) against the JAX package.

The same numpy-made streams are packed into dense batches by both
packages' ``pack_buffer_2bit`` (asserted byte-equal). ``krust_tpu`` runs
its dense step, ``codec.unpack_2bit`` -> ``pallas_codec.
encode_blocks_pallas`` (interpret mode) -> ``engines._sentinel_part``, and
its jnp codec ``codec.encode_blocks``; the port runs ``encode_dense_plain``.
Both emit row-major window order, so keys are compared position for
position (integer work: tolerance 0), across k, bad-base shares of 0, 5%
and 30%, all-bad padding rows and a last row that ends mid-byte.

The rest of ``codec.py``'s surface against ``krust_tpu.ops.codec``:
``encode_blocks`` (its plain version, and the packed route the CUDA path
takes, pack -> ``encode_dense`` -> split, here on ``encode_dense``'s plain
version) on clean, dirty (about 7% bad) and quality-masked rows (threshold
53, ``"5"``, Q20) at k in {1, 2, 15, 16, 17, 21, 31, 32}: ``hi``, ``lo``
and ``valid`` equal bit for bit on every window, a window that holds a bad
base included (``krust_tpu``'s code of the window with each bad base taken
as 0 on both strands); K4's code form (``encode_dense(..., codes=True)``)
against its counting form; ``unpack_2bit``; ``split64`` / ``combine64``.

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
from krust_tpu.ops import codec as jax_codec
from krust_tpu.ops.codec import encode_blocks, unpack_2bit
from krust_tpu.ops.pallas_codec import encode_blocks_pallas
from krust_tpu_torch.io import packer
from krust_tpu_torch.ops import codec as port_codec
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


# --- encode_blocks, unpack_2bit, split64 / combine64 ---------------------------------

#: rows and windows of every encode_blocks case: 37 windows is no multiple
#: of 4, so the packed route widens the rows and slices the padding off
BLOCK_ROWS, BLOCK_W = 6, 37
Q20 = ord("5")


def _rows(k, kind, seed):
    """codes [BLOCK_ROWS, BLOCK_W + k - 1] and quality bytes: clean rows,
    about 7% bad bases, or about 5% of the bases below Q20."""
    rng = np.random.default_rng(seed)
    shape = (BLOCK_ROWS, BLOCK_W + k - 1)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    qual = np.full(shape, ord("I"), np.uint8)
    if kind == "dirty":
        codes[rng.random(shape) < 0.07] = rng.integers(4, 256, dtype=np.uint8)
    if kind == "quality":
        qual[rng.random(shape) < 0.05] = rng.integers(33, Q20, dtype=np.uint8)
        qual[0, :3] = Q20  # at the threshold: kept
    if k == 32:  # G...C rows: canonical codes with bit 63 set
        codes[1] = np.where(np.arange(shape[1]) % 2, 1, 2)
    return codes, qual


def _check_blocks(got, exp, k):
    hi, lo, valid = got
    e_hi, e_lo, e_valid = (np.asarray(a) for a in exp)
    assert (hi.dtype, lo.dtype, valid.dtype) == (torch.uint32, torch.uint32, torch.bool)
    assert hi.shape == lo.shape == valid.shape == (BLOCK_ROWS, BLOCK_W)
    hi, lo, valid = hi.numpy(), lo.numpy(), valid.numpy()
    np.testing.assert_array_equal(valid, e_valid)
    np.testing.assert_array_equal(hi, e_hi)  # every window, invalid ones too
    np.testing.assert_array_equal(lo, e_lo)
    if k <= 16:
        assert not hi.any()


@pytest.mark.parametrize("kind", ["clean", "dirty", "quality"])
@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 21, 31, 32])
def test_encode_blocks_matches_jax(k, kind):
    codes, qual = _rows(k, kind, seed=k + 40 * len(kind))
    thr = Q20 if kind == "quality" else None
    exp = jax_codec.encode_blocks(codes, k, qual if thr else None, thr)
    args = (torch.from_numpy(codes), k, torch.from_numpy(qual) if thr else None, thr)
    _check_blocks(port_codec.encode_blocks(*args), exp, k)
    _check_blocks(port_codec._encode_packed(*args), exp, k)
    if kind != "clean":
        assert not np.asarray(exp[2]).all()


@pytest.mark.parametrize("w", [64, 37 + 3, 8])
@pytest.mark.parametrize("k", [1, 16, 17, 32])
def test_code_form_against_counting_form(k, w):
    """K4's two forms on the same dense rows (about 10% bad bits, an
    all-bad row): the code form's keys where its poison bits are clear are
    the counting form's keys, the counting form's sentinels lie where they
    are set, and its poison words mark the windows past W as poisoned."""
    rng = np.random.default_rng(k * 100 + w)
    rows, width = 5, w + k - 1
    p4, p8 = -(-width // 4), -(-width // 8)
    packed2 = torch.from_numpy(rng.integers(0, 256, (rows, p4), dtype=np.uint8))
    bad = rng.random((rows, 8 * p8)) < 0.1
    bad[2] = True
    badbits = torch.from_numpy(np.packbits(bad, axis=1))
    keys, poison = encode_dense(packed2, badbits, k, w, codes=True)
    counted = encode_dense(packed2, badbits, k, w)
    assert poison.dtype == torch.int32 and poison.shape == (rows, -(-w // 32))
    valid = port_codec.valid_of(poison, w).reshape(-1)
    assert torch.equal(keys[valid], counted[valid])
    assert torch.all(counted[~valid] == sentinel(key_dtype(k)))
    assert not valid.view(rows, w)[2].any()
    assert torch.equal(port_codec.poison_words(~valid.view(rows, w)), poison)
    if w % 32:  # bits past W are set
        assert torch.all((poison[:, -1] >> (w % 32)) == -1)


def test_encode_blocks_quality_needs_both():
    """A threshold without quality bytes, or quality without a threshold,
    filters nothing (as in krust_tpu)."""
    codes, qual = _rows(21, "quality", seed=9)
    plain = port_codec.encode_blocks(torch.from_numpy(codes), 21)
    for q, t in ((torch.from_numpy(qual), None), (None, Q20)):
        got = port_codec.encode_blocks(torch.from_numpy(codes), 21, q, t)
        assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_encode_blocks_rejects_bad_input():
    codes = torch.zeros((2, 40), dtype=torch.uint8)
    with pytest.raises(ValueError):
        port_codec.encode_blocks(codes, 33)
    with pytest.raises(ValueError):
        port_codec.encode_blocks(codes.to(torch.int32), 21)
    with pytest.raises(ValueError):
        port_codec.encode_blocks(codes, 21, torch.zeros((2, 39), dtype=torch.uint8), Q20)


@pytest.mark.parametrize("width", [1, 29, 64])
def test_unpack_2bit_matches_jax(width):
    rng = np.random.default_rng(width)
    packed2 = rng.integers(0, 256, size=(5, -(-width // 4)), dtype=np.uint8)
    badbits = rng.integers(0, 256, size=(5, -(-width // 8)), dtype=np.uint8)
    got = port_codec.unpack_2bit(torch.from_numpy(packed2), torch.from_numpy(badbits), width)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(unpack_2bit(packed2, badbits, width)))


@pytest.mark.parametrize("k", [5, 21])
def test_pack_rows_round_trips_through_unpack(k):
    """The CUDA route's packer: bases at 4 a byte and bad bits at 8 a byte
    that unpack to the rows, every padding base bad; every bad base (an
    invalid code, an ACGT base below the quality threshold) and the
    padding packed as 2-bit 0, ``krust_tpu``'s substitution."""
    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(0, 6, size=(4, 30 + k - 1), dtype=np.uint8))
    qual = torch.from_numpy(np.where(rng.random(codes.shape) < 0.2, 40, 73).astype(np.uint8))
    packed2, badbits, w4 = port_codec.pack_rows(codes, k)
    assert w4 == 32
    back = port_codec.unpack_2bit(packed2, badbits, w4 + k - 1)
    assert torch.equal(back[:, : codes.shape[1]], torch.where(codes < 4, codes, 4))
    assert torch.all(back[:, codes.shape[1]:] == 4)
    packed2, badbits, _ = port_codec.pack_rows(codes, k, qual, Q20)
    good = (codes < 4) & (qual >= Q20)
    raw = port_codec.unpack_2bit(packed2, torch.zeros_like(badbits), w4 + k - 1)
    assert torch.equal(raw[:, : codes.shape[1]], torch.where(good, codes, 0))
    assert torch.all(raw[:, codes.shape[1]:] == 0)
    back = port_codec.unpack_2bit(packed2, badbits, w4 + k - 1)
    assert torch.equal(back[:, : codes.shape[1]] < 4, good)


def test_split64_combine64_match_jax():
    rng = np.random.default_rng(64)
    codes = np.concatenate([
        rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64, endpoint=True),
        np.array([0, 1, 2**32 - 1, 2**32, 2**63, 2**63 + 5, 2**64 - 1], np.uint64),
    ])
    hi, lo = port_codec.split64(codes)
    e_hi, e_lo = jax_codec.split64(codes)
    assert hi.dtype == lo.dtype == np.uint32
    np.testing.assert_array_equal(hi, e_hi)
    np.testing.assert_array_equal(lo, e_lo)
    back = port_codec.combine64(hi, lo)
    assert back.dtype == np.uint64
    np.testing.assert_array_equal(back, codes)
    np.testing.assert_array_equal(back, jax_codec.combine64(hi, lo))
