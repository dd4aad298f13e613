"""CUDA kernels of krust_tpu_torch against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc: every test is marked ``cuda`` and skips here
without a CUDA device. The file imports neither jax nor ``krust_tpu``, so on
the GPU machine (which has no jax) it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Integer work: kernel and plain version must be exactly equal.
"""

import numpy as np
import pytest
import torch

from krust_tpu_torch.io.packer import pack2_full, pack_buffer_2bit
from krust_tpu_torch.io.reader import ParsedStreams
from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.models.engines import BatchEngine, NumpyEngine
from krust_tpu_torch.ops.fused_codec import TAIL_BYTES, encode_windows, encode_windows_plain
from krust_tpu_torch.ops.codec import encode_dense, encode_dense_plain
from krust_tpu_torch.ops.merge import (
    merge_sorted, merge_sorted_keys, merge_sorted_keys_plain, merge_sorted_plain,
)
from krust_tpu_torch.ops.rle import rle_compact, rle_compact_plain
from krust_tpu_torch.utils.config import EngineConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sorted_keys(g, n, span, dtype, dev, sentinel_share):
    lo = torch.iinfo(dtype).min
    keys = torch.sort(
        torch.randint(lo, lo + span, (n,), generator=g, device=dev, dtype=dtype)
    ).values
    keys[n - int(n * sentinel_share) :] = torch.iinfo(dtype).max
    return keys


def _invalid_stream(case, rng, k, n_bases, tile):
    """Base codes of a codec case, and the windows it covers."""
    stream = rng.integers(0, 4, size=n_bases, dtype=np.uint8)
    n_windows = n_bases - k + 1
    covered = n_windows - 77  # a ragged tail inside the last tile
    if case in ("dirty", "unaligned"):
        stream[rng.random(n_bases) < 0.01] = INVALID_CODE
    elif case == "all_invalid":
        stream[:] = INVALID_CODE
    elif case == "tile_edges":  # invalid runs across each tile edge, covered at one
        for edge in range(tile, n_bases, tile):
            stream[max(edge - k, 0) : edge + 2] = INVALID_CODE
        stream[tile // 2 : tile // 2 + 40] = INVALID_CODE
        covered = 2 * tile
    return stream, covered


@pytest.mark.parametrize("case", ["dirty", "clean", "all_invalid", "tile_edges", "unaligned"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 15, 16, 17, 21, 31, 32])
def test_codec_kernel_matches_plain(dev, k, case):
    """K1 over three whole tiles and a partial one: 1% invalid bases, none,
    every one, invalid runs across tile edges with ``covered`` at an edge,
    and packed bytes that start off a 16-byte boundary (the byte loads)."""
    from krust_tpu_torch.ops import _cuda

    tile = _cuda.library().krust_encode_windows_tile()
    rng = np.random.default_rng(11 + k)
    n_windows = 3 * tile + tile // 4
    stream, covered = _invalid_stream(case, rng, k, n_windows + k - 1, tile)
    if k == 32:
        stream[:300] = 2  # canonical 32-mers with bit 63 set
    inv = np.flatnonzero(stream >= INVALID_CODE).astype(np.int32)
    invpos = np.concatenate([inv, np.full(5, stream.shape[0], np.int32)])  # padding
    if case == "clean":
        invpos = inv  # no positions at all
    skew = 1 if case == "unaligned" else 0
    packed = np.zeros(skew + n_windows // 4 + TAIL_BYTES, np.uint8)
    p = pack2_full(stream)
    packed[skew : skew + p.shape[0]] = p
    pk = torch.from_numpy(packed).to(dev)[skew:]
    iv = torch.from_numpy(invpos).to(dev)
    got = encode_windows(pk, iv, covered, k, n_windows)
    assert torch.equal(got, encode_windows_plain(pk, iv, covered, k, n_windows))


_RLE_SIZES = {"empty": lambda t: 0, "one": lambda t: 1, "tile-1": lambda t: t - 1,
              "tile": lambda t: t, "tile+1": lambda t: t + 1,
              "3tiles+5": lambda t: 3 * t + 5, "300001": lambda t: 300_001}


def _rle_stream(case, g, dtype, dev):
    """Sorted sentinel-padded keys of an RLE case, sized from the kernel's
    tile: random runs around one tile, a stream of sentinels only, the first
    sentinel exactly at a tile edge, one run over three tiles."""
    from krust_tpu_torch.ops import _cuda

    tile = _cuda.library().krust_rle_tile(torch.iinfo(dtype).bits // 8)
    if case in _RLE_SIZES:
        return _sorted_keys(g, _RLE_SIZES[case](tile), 1000, dtype, dev, 0.2)
    sent = torch.iinfo(dtype).max
    if case == "all_sentinel":
        return torch.full((3 * tile + 7,), sent, dtype=dtype, device=dev)
    if case == "sentinel_at_tile":
        keys = _sorted_keys(g, 3 * tile, 1000, dtype, dev, 0.0)
        keys[2 * tile :] = sent
        return keys
    assert case == "run_over_3_tiles"
    keys = _sorted_keys(g, 5 * tile, 1000, dtype, dev, 0.1)
    keys[tile // 2 : tile // 2 + 3 * tile + 1] = keys[tile // 2].item()
    return keys


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("case", [*_RLE_SIZES, "all_sentinel", "sentinel_at_tile",
                                  "run_over_3_tiles"])
def test_rle_kernel_matches_plain(dev, dtype, weighted, case):
    g = torch.Generator(device=dev)
    g.manual_seed(len(case))
    keys = _rle_stream(case, g, dtype, dev)
    n = keys.numel()
    cnt = (
        torch.randint(1, 50, (n,), generator=g, device=dev, dtype=torch.int32)
        if weighted else None
    )
    for a, b in zip(rle_compact(keys, cnt), rle_compact_plain(keys, cnt)):
        assert torch.equal(a, b)


def _merge_tile(key_bytes):
    from krust_tpu_torch.ops import _cuda

    return _cuda.library().krust_merge_tile(key_bytes)


#: part lengths relative to the kernel's tile t, around its edges
_MERGE_SIZES = {"1-0": lambda t: (1, 0), "0-5": lambda t: (0, 5),
                "1000-3": lambda t: (1000, 3), "70000-130001": lambda t: (70_000, 130_001),
                "1-tile": lambda t: (1, t), "tile-1": lambda t: (t - 1, t + 1),
                "tile": lambda t: (t, t), "tile+1": lambda t: (t + 1, t - 1),
                "3tiles+1": lambda t: (3 * t + 1, 2 * t)}
_MERGE_CASES = [*_MERGE_SIZES, "b_in_a", "all_equal", "a_below_b", "b_below_a",
                "sentinel_tiles", "biased_ends"]


def _sorted_np(rng, n, lo, hi, dtype):
    return np.sort(rng.integers(lo, hi, n, dtype=np.int64, endpoint=True)).astype(dtype)


def _merge_parts(case, rng, dtype):
    """Two sorted key arrays of a merge case, sized from the kernel's tile:
    random parts around tile edges; b's keys all in a (the main path's
    case); every key equal, so every diagonal lands on a tie; one part
    wholly below the other; sentinel tails over whole tiles; keys at both
    ends of the biased range (k = 32 codes with bit 63 set, k = 16 codes
    with bit 31 set) next to the sentinel."""
    np_dtype = np.int32 if dtype == torch.int32 else np.int64
    info = np.iinfo(np_dtype)
    t = _merge_tile(info.bits // 8)
    if case in _MERGE_SIZES:
        ma, mb = _MERGE_SIZES[case](t)
        parts = [_sorted_np(rng, m, info.min, info.min + 5000, np_dtype) for m in (ma, mb)]
        for p in parts:
            p[len(p) - len(p) // 4 :] = info.max
        return parts
    if case == "b_in_a":
        a = np.unique(rng.integers(info.min, info.min + 2**30, 3 * t + 77)).astype(np_dtype)
        b = np.sort(a[rng.random(a.size) < 0.997])
        return a, b
    if case == "all_equal":
        return np.full(2 * t + 3, 12345, np_dtype), np.full(3 * t - 1, 12345, np_dtype)
    if case in ("a_below_b", "b_below_a"):
        lo = _sorted_np(rng, 2 * t + 5, info.min, -1, np_dtype)
        hi = _sorted_np(rng, 3 * t - 9, 0, info.max - 1, np_dtype)
        return (lo, hi) if case == "a_below_b" else (hi, lo)
    if case == "sentinel_tiles":
        a = _sorted_np(rng, 4 * t, info.min, info.min + 5000, np_dtype)
        b = _sorted_np(rng, 3 * t + 1, info.min, info.min + 5000, np_dtype)
        a[t // 2 :] = info.max
        b[t:] = info.max
        return a, b
    assert case == "biased_ends"
    a = _sorted_np(rng, 2 * t + 11, info.min, info.max - 1, np_dtype)
    b = _sorted_np(rng, t + 7, info.min, info.max - 1, np_dtype)
    a[:3] = info.min
    b[:2] = info.min
    a[-5:-2] = info.max - 1
    a[-2:] = info.max
    b[-1] = info.max - 1
    return a, b


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", _MERGE_CASES)
def test_merge_kernel_matches_plain(dev, dtype, case):
    """K3 at the partition's hard cases: equal to the stable merge of
    cat(a, b), counts following their keys."""
    rng = np.random.default_rng(len(case))
    a, b = (torch.from_numpy(x).to(dev) for x in _merge_parts(case, rng, dtype))
    ac, bc = (torch.from_numpy(rng.integers(0, 500, x.numel(), dtype=np.int32)).to(dev)
              for x in (a, b))
    got = merge_sorted(a, ac, b, bc)
    exp = merge_sorted_plain(a, ac, b, bc)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("k", [5, 16, 21, 32])
def test_engine_on_cuda_matches_numpy(dev, monkeypatch, k):
    """The device engine with small epochs: codec, sort, RLE and merges,
    every kernel launched on the card."""
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "4096")
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 60_000, dtype=np.uint8)
    codes[rng.random(60_000) < 0.01] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 60_000)
    before = {f: f.launches for f in (encode_windows, rle_compact, merge_sorted)}
    cfg = EngineConfig(block_windows=256, batch_rows=8, device=dev)
    got = BatchEngine(cfg).count(s, k)
    exp = NumpyEngine().count(s, k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert all(f.launches > n for f, n in before.items())


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 15, 16, 17, 21, 24, 31, 32])
@pytest.mark.parametrize("w", [8, 256], ids=["w8", "w256"])
def test_dense_codec_kernel_matches_plain(dev, k, w):
    """K4 at edge k and widths, on exact-size tensors (the last group of the
    last row reads up to the row's end), with all-bad padding rows and a
    last row that ends mid-byte."""
    rng = np.random.default_rng(31 + k + w)
    n = 13 * w + 3 + k - 1  # 14 real rows, the last with 3 windows
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    codes[rng.random(n) < 0.07] = INVALID_CODE
    if k == 32:
        codes[: 3 * w] = 2  # canonical 32-mers with bit 63 set
    (batch,) = pack_buffer_2bit(codes, None, k, None, w)
    p2 = torch.from_numpy(batch.packed2).to(dev)
    bb = torch.from_numpy(batch.badbits).to(dev)
    got = encode_dense(p2, bb, k, w)
    assert torch.equal(got, encode_dense_plain(p2, bb, k, w))


_MERGE_KEYS_CASES = ["0", "1", "127", "1000", "300001", "tile-1", "tile", "tile+1",
                     "3tiles+1", "b_in_a", "all_equal", "a_below_b", "b_below_a",
                     "high_half"]


def _merge_keys_parts(case, rng):
    """Two sorted uint32 arrays of one length m: ties inside and across
    them, keys at or above 2^31, sentinel tails (0xFFFFFFFF)."""
    t = _merge_tile(4)
    sizes = {"tile-1": t - 1, "tile": t, "tile+1": t + 1, "3tiles+1": 3 * t + 1}
    if case.isdigit() or case in sizes:
        m = int(case) if case.isdigit() else sizes[case]
        pool = rng.integers(0, 1 << 32, 500, dtype=np.uint64).astype(np.uint32)
        a = np.sort(rng.choice(pool, m))
        b = np.sort(rng.choice(pool, m))
        a[m - m // 4 :] = 0xFFFFFFFF
        return a, b
    m = 2 * t + 13
    if case == "b_in_a":
        a = np.sort(rng.integers(0, 1 << 32, m, dtype=np.uint64)).astype(np.uint32)
        return a, np.sort(a[rng.integers(0, m, m)])
    if case == "all_equal":
        return np.full(m, 0x80000000, np.uint32), np.full(m, 0x80000000, np.uint32)
    if case in ("a_below_b", "b_below_a"):
        lo = np.sort(rng.integers(0, 1 << 31, m, dtype=np.uint64)).astype(np.uint32)
        hi = np.sort(rng.integers(1 << 31, 1 << 32, m, dtype=np.uint64)).astype(np.uint32)
        return (lo, hi) if case == "a_below_b" else (hi, lo)
    assert case == "high_half"  # every key at or above 2^31, both ends of it
    a, b = (np.sort(rng.integers(1 << 31, 1 << 32, m, dtype=np.uint64)).astype(np.uint32)
            for _ in range(2))
    a[:2] = 0x80000000
    a[-3:] = 0xFFFFFFFF
    b[-1] = 0xFFFFFFFE
    return a, b


@pytest.mark.parametrize("case", _MERGE_KEYS_CASES)
def test_merge_keys_kernel_matches_plain(dev, case):
    """K5: ties, keys at or above 2^31, sentinel tails and tile edges."""
    a, b = _merge_keys_parts(case, np.random.default_rng(len(case)))
    m = a.shape[0]
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    got = merge_sorted_keys(ta, tb).view(torch.int32)  # CUDA compares no uint32
    assert torch.equal(got, merge_sorted_keys_plain(ta, tb).view(torch.int32))
    with pytest.raises(ValueError, match="equal shape"):
        merge_sorted_keys(ta, torch.from_numpy(np.zeros(m + 1, np.uint32)).to(dev))


def test_dense_input_raises_on_cuda(dev):
    """Dirty input, and a geometry the flat layout cannot hold, count on the
    dense kernel path; a geometry the dense packer refuses raises."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    codes[rng.random(5000) < 0.2] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 5000)
    with pytest.raises(ValueError, match="multiple of 8"):
        BatchEngine(EngineConfig(block_windows=260, device=dev)).count(s, 11)
    exp = NumpyEngine().count(s, 11)
    for w in (4096, 8):
        flat, dense = encode_windows.launches, encode_dense.launches
        got = BatchEngine(EngineConfig(block_windows=w, device=dev)).count(s, 11)
        np.testing.assert_array_equal(got.codes, exp.codes)
        np.testing.assert_array_equal(got.counts, exp.counts)
        assert encode_dense.launches > dense and encode_windows.launches == flat


@pytest.mark.parametrize("k", [5, 16, 21, 32])
def test_dense_engine_on_cuda_matches_numpy(dev, monkeypatch, k):
    """The dense path with small epochs: K4, sort, RLE and merges, every
    one launched on the card."""
    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "4096")
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 60_000, dtype=np.uint8)
    codes[rng.random(60_000) < 0.08] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 60_000)
    before = {f: f.launches for f in (encode_dense, rle_compact, merge_sorted)}
    cfg = EngineConfig(block_windows=256, batch_rows=8, device=dev)
    got = BatchEngine(cfg).count(s, k)
    exp = NumpyEngine().count(s, k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert all(f.launches > n for f, n in before.items())
