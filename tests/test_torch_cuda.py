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
from krust_tpu_torch.models.engines import BatchEngine, NativeEngine, NumpyEngine
from krust_tpu_torch.ops.fused_codec import TAIL_BYTES, encode_windows, encode_windows_plain
from krust_tpu_torch.ops.codec import (
    encode_blocks, encode_blocks_plain, encode_dense, encode_dense_plain,
)
from krust_tpu_torch.ops.count import (
    count_runs, count_unique, merge_runs, merge_runs_presorted, merge_weighted,
)
from krust_tpu_torch.ops.merge import (
    merge_sorted, merge_sorted_keys, merge_sorted_keys_plain, merge_sorted_plain,
)
from krust_tpu_torch.ops.histogram import BINS, count_histogram, count_histogram_plain
from krust_tpu_torch.ops.rle import rle_compact, rle_compact_plain
from krust_tpu_torch.ops import table as table_mod
from krust_tpu_torch.ops.table import DeviceTable
from krust_tpu_torch.parallel.mesh import init_distributed, make_mesh
from krust_tpu_torch.parallel.sharded import _owner_of, count_sharded
from krust_tpu_torch.utils import tracing
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
@pytest.mark.parametrize("k", range(1, 33))
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


@pytest.mark.parametrize("k", range(1, 33))
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
    for g, e in zip(encode_dense(p2, bb, k, w, codes=True),
                    encode_dense_plain(p2, bb, k, w, codes=True)):
        assert torch.equal(g, e)  # the code form: codes and poison words


@pytest.mark.parametrize("quality", [False, True], ids=["codes", "quality"])
@pytest.mark.parametrize("k", range(1, 33))
def test_encode_blocks_on_cuda_matches_plain(dev, k, quality):
    """``encode_blocks`` on the card (pack, K4's code form once, split)
    against its plain version on the same rows, ``hi``, ``lo`` and
    ``valid`` on every window, invalid ones included: 7% bad bases, with
    quality bytes 5% below the threshold 53 (Q20), 37 windows a row
    (widened to 40 for K4 and sliced back)."""
    rng = np.random.default_rng(77 + k + 100 * quality)
    shape = (33, 37 + k - 1)
    codes = rng.integers(0, 4, size=shape, dtype=np.uint8)
    codes[rng.random(shape) < 0.07] = INVALID_CODE
    if k == 32:
        codes[0] = 2  # canonical 32-mers with bit 63 set
    qual = np.where(rng.random(shape) < 0.05, ord("#"), ord("I")).astype(np.uint8)
    args = (torch.from_numpy(codes).to(dev), k,
            torch.from_numpy(qual).to(dev) if quality else None, ord("5") if quality else None)
    before = encode_dense.launches
    got = encode_blocks(*args)
    assert encode_dense.launches == before + 1
    exp = encode_blocks_plain(*args)
    assert [t.dtype for t in got] == [torch.uint32, torch.uint32, torch.bool]
    for g, e in zip(got, exp):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), e.cpu())
    assert 0 < int(got[2].sum()) < got[2].numel()


def _dense_rows(rng, case, rows, w, k):
    """Base codes and bad flags [rows, w + k - 1] of a dense codec case."""
    width = w + k - 1
    bases = rng.integers(0, 4, size=(rows, width), dtype=np.uint8)
    bad = np.zeros((rows, width), bool)
    if case == "dirty":  # 7% bad, an all-bad row between good rows
        bad = rng.random((rows, width)) < 0.07
        bad[rows // 2] = rows >= 3
        if k == 32:
            bases[0] = 2  # canonical 32-mers with bit 63 set
    elif case != "clean":  # one bad base a row
        bad[:, {"first": 0, "last_window": w - 1, "last_halo": width - 1}[case]] = True
    return bases, bad


def _skewed(arr, skew, dev):
    """``arr`` [rows, n] on the card as a contiguous view that starts ``skew``
    bytes into its buffer and ends at the buffer's last byte."""
    buf = torch.zeros(skew + arr.size, dtype=torch.uint8, device=dev)
    buf[skew:] = torch.from_numpy(arr.reshape(-1)).to(dev)
    return buf[skew:].view(arr.shape)


@pytest.mark.parametrize("rows", [1, 3, 100])
@pytest.mark.parametrize("k", [1, 2, 5, 15, 16, 17, 21, 31, 32])
@pytest.mark.parametrize("w", [4, 8, 36, 256, 4096, 8192])
def test_dense_codec_tile_matches_plain(dev, w, k, rows):
    """K4's tile at row widths below, at and above a block's 4096 windows
    and at a width that is no multiple of 32 (the direct-store path): no bad
    bit, one on each row's first base, on its last window's first base and
    on its last halo base, and 7% bad bits with an all-bad row between good
    rows; both forms (the counting form's keys, the code form's codes and
    poison words); each on tensors that start 0..15 bytes off a 16-byte
    boundary (the rows' odd strides give every offset) and end at their
    buffer's last byte."""
    rng = np.random.default_rng(1000 * w + 10 * k + rows)
    width = w + k - 1
    p4, p8 = -(-width // 4), -(-width // 8)
    for case in ("clean", "first", "last_window", "last_halo", "dirty"):
        bases, bad = _dense_rows(rng, case, rows, w, k)
        quads = np.zeros((rows, 4 * p4), np.uint8)
        quads[:, :width] = bases
        q = quads.reshape(rows, p4, 4)
        packed2 = q[:, :, 0] << 6 | q[:, :, 1] << 4 | q[:, :, 2] << 2 | q[:, :, 3]
        flags = np.ones((rows, 8 * p8), bool)  # padding is bad
        flags[:, :width] = bad
        badbits = np.packbits(flags, axis=1)
        skew4, skew8 = (0, 0) if case == "clean" else rng.integers(1, 16, 2)
        p2 = _skewed(np.ascontiguousarray(packed2), int(skew4), dev)
        bb = _skewed(badbits, int(skew8), dev)
        got = encode_dense(p2, bb, k, w)
        exp = encode_dense_plain(p2, bb, k, w)
        assert torch.equal(got, exp), case
        for g, e in zip(encode_dense(p2, bb, k, w, codes=True),
                        encode_dense_plain(p2, bb, k, w, codes=True)):
            assert torch.equal(g, e), case  # the code form
        if case in ("first", "last_window", "last_halo"):  # its windows only
            n_bad = (got.view(rows, w) == torch.iinfo(got.dtype).max).sum(1)
            assert n_bad.unique().tolist() == [min(k, w) if case == "last_window" else 1]


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


def _weighted_keys(rng, n, dtype, zero_share):
    """n keys from a small pool that reaches both ends of the biased range,
    sentinels among them, with weights of which ``zero_share`` are 0."""
    info = np.iinfo(np.int32 if dtype == torch.int32 else np.int64)
    pool = np.concatenate([rng.integers(info.min, info.max, 300, dtype=np.int64),
                           [info.min, info.max - 1, info.max]]).astype(info.dtype)
    keys = pool[rng.integers(0, pool.size, n)]
    weight = rng.integers(1, 90, n).astype(np.int32)
    weight[rng.random(n) < zero_share] = 0
    return torch.from_numpy(keys), torch.from_numpy(weight)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [0, 1, 5000, 300_001])
def test_count_functions_on_cuda_match_cpu(dev, dtype, n):
    """The five ``ops/count`` functions on the card (``torch.sort`` there,
    K2 launched) against the same call on CPU tensors (K2's plain version):
    zero weights, sentinels (the all-ones code where valid) and runs whose
    weights are all zero."""
    rng = np.random.default_rng(n + (dtype == torch.int32))
    keys, weight = _weighted_keys(rng, n, dtype, 0.3)
    valid = torch.from_numpy(rng.random(n) < 0.8)
    s_keys, order = torch.sort(keys)
    calls = [(merge_weighted, (keys, weight, valid)), (count_unique, (keys, valid)),
             (count_runs, (keys, valid)), (merge_runs, (keys, weight)),
             (merge_runs_presorted, (s_keys, weight[order]))]
    for fn, args in calls:
        before = rle_compact.launches
        got = fn(*(a.to(dev) for a in args))
        assert rle_compact.launches == before + 1, fn.__name__
        for a, b in zip(got, fn(*args)):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b), fn.__name__


@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize("max_parts", [2, 8])
def test_device_table_on_cuda_matches_cpu(dev, k, max_parts):
    """The LSM table on the card against the same adds on the CPU: raw keys
    with unit weights and weighted parts, several compactions."""
    rng = np.random.default_rng(k + max_parts)
    dtype = torch.int32 if k <= 16 else torch.int64
    on_card, on_cpu = DeviceTable(k, max_parts, device=dev), DeviceTable(k, max_parts, device="cpu")
    before = rle_compact.launches
    for i in range(11):
        keys, weight = _weighted_keys(rng, 20_000, dtype, 0.2)
        cnt = None if i % 2 else weight
        on_card.add(keys.to(dev), None if cnt is None else cnt.to(dev), 20_000)
        on_cpu.add(keys, cnt, 20_000)
    got, exp = on_card.finalize(), on_cpu.finalize()
    np.testing.assert_array_equal(got[0], exp[0])
    np.testing.assert_array_equal(got[1], exp[1])
    assert got[0].size > 0 and rle_compact.launches - before == -(-11 // max_parts)


@pytest.mark.parametrize("dirty", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("k", [5, 16, 21, 32])
def test_lsm_engine_on_cuda_matches_numpy(dev, monkeypatch, k, dirty):
    """``use_epoch_sort=False`` on the card: the codec kernel of the route,
    compactions by ``merge_runs`` (K2 launched), no part merge."""
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", "5000")
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 60_000, dtype=np.uint8)
    codes[rng.random(60_000) < (0.08 if dirty else 0.01)] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 60_000)
    codec = encode_dense if dirty else encode_windows
    before = {f: f.launches for f in (codec, rle_compact, merge_sorted)}
    cfg = EngineConfig(block_windows=256, batch_rows=8, device=dev, use_epoch_sort=False)
    got = BatchEngine(cfg).count(s, k)
    exp = NumpyEngine().count(s, k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert codec.launches > before[codec] and rle_compact.launches > before[rle_compact] + 1
    assert merge_sorted.launches == before[merge_sorted]


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_owner_of_on_cuda_matches_cpu(dev, dtype):
    """The exchange's owner function on the card equals its CPU result at
    every n of the tests (2^20 random keys, the key space's ends)."""
    info = torch.iinfo(dtype)
    g = torch.Generator().manual_seed(5)
    keys = torch.cat([torch.randint(info.min, info.max, (1 << 20,), generator=g, dtype=dtype),
                      torch.tensor([info.min, info.min + 1, info.max - 1, info.max],
                                   dtype=dtype)])
    for n in (2, 3, 4, 6, 8, 16):
        got = _owner_of(keys.to(dev), n)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), _owner_of(keys, n)), n


def test_count_functions_raise_on_mixed_devices(dev):
    """No fallback: a CUDA key tensor with CPU weights raises."""
    keys = torch.arange(8, dtype=torch.int64)
    with pytest.raises((RuntimeError, ValueError)):
        merge_runs(keys.to(dev), torch.ones(8, dtype=torch.int32))


def _sharded_stream(k, dirty, n=60_000):
    rng = np.random.default_rng(900 + k + dirty)
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    codes[rng.random(n) < (0.08 if dirty else 0.01)] = INVALID_CODE
    if k == 32:  # canonical 32-mers with bit 63 set
        codes[:600] = np.where(codes[:600] == INVALID_CODE, INVALID_CODE, 2)
    return ParsedStreams(codes, None, 1, n)


@pytest.mark.parametrize("dirty", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("k", range(1, 33))
def test_sharded_count_on_cuda_matches_native(dev, monkeypatch, k, dirty):
    """``count_sharded`` in a world of one on the card at every k, on both
    routes, with an exchange every two batches: the route's codec kernel
    and K2 launched, the table equal to the native core's."""
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * 8 * 256)
    s = _sharded_stream(k, dirty)
    codec = encode_dense if dirty else encode_windows
    other = encode_windows if dirty else encode_dense
    before = {f: f.launches for f in (codec, other, rle_compact)}
    cfg = EngineConfig(block_windows=256, batch_rows=8, device=dev)
    got = count_sharded(s, k, config=cfg)
    exp = NativeEngine().count(s, k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert codec.launches > before[codec] and other.launches == before[other]
    assert rle_compact.launches > before[rle_compact]


@pytest.mark.parametrize("dirty", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("k", [5, 16, 21, 32])
@pytest.mark.parametrize("cards", ["4 slots on one card", "every card"])
def test_local_mesh_on_cuda_matches_native(dev, monkeypatch, k, dirty, cards):
    """One process over a mesh on the card(s): batches dealt to the slots,
    an exchange every two groups (K3 and K2 per destination, the gather by
    K3 on the first card), the table equal to the native core's; the
    kernels leave the current device as they found it."""
    if cards == "every card" and torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = (make_mesh(devices=["cuda:0"] * 4) if cards == "4 slots on one card"
            else make_mesh())
    monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * mesh.size * 8 * 256)
    s = _sharded_stream(k, dirty)
    codec = encode_dense if dirty else encode_windows
    before = {f: f.launches for f in (codec, merge_sorted, rle_compact)}
    current = torch.cuda.current_device()
    got = count_sharded(s, k, mesh=mesh, config=EngineConfig(block_windows=256, batch_rows=8))
    exp = NativeEngine().count(s, k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert all(f.launches > n for f, n in before.items())
    assert torch.cuda.current_device() == current


@pytest.mark.parametrize("slots", [1, 4])
@pytest.mark.parametrize("k", [5, 21])
def test_sharded_exchange_in_a_one_rank_nccl_group(dev, tmp_path, k, slots):
    """With a process group the exchange runs on the card: owner order and
    the split sizes through NCCL, then K3 and K2 per slot; one slot sends
    each entry once, 4 slots of the one card as many, none across
    processes."""
    spans = []

    def collect(kind, name, fields):
        if name == "sharded_exchange":
            spans.append(fields)

    s = _sharded_stream(k, False)
    init_distributed(f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    tracing.add_collector(collect)
    before = merge_sorted.launches
    try:
        mesh = make_mesh(devices=[dev] * slots)
        got = count_sharded(s, k, mesh=mesh,
                            config=EngineConfig(block_windows=256, batch_rows=8))
    finally:
        tracing.remove_collector(collect)
        torch.distributed.destroy_process_group()
    exp = NativeEngine().count(s, k)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert (mesh.size, [x["devices"] for x in spans]) == (slots, [slots])
    assert [x["process_bytes"] + x["wire_bytes"] for x in spans] == [0]
    if slots == 1:
        assert [x["sent_bytes"] for x in spans] == [got.distinct * (8 if k <= 16 else 12)]
    else:
        assert merge_sorted.launches > before


# --- the public surface on the card: chunked ingest, stdin CLI, .kmix ----------


def _write_reads_fq(path, seed, n_rate):
    """Seeded FASTQ: 60 reads of 20-400 bases, ``n_rate`` of them N, 3%
    below Q20, 5% soft-masked."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lines = []
    for i in range(60):
        n = int(rng.integers(20, 400))
        s = acgt[rng.integers(0, 4, n)].copy()
        s[rng.random(n) < n_rate] = ord("N")
        s[rng.random(n) < 0.05] += 32
        q = np.where(rng.random(n) < 0.03, ord("#"), ord("I")).astype(np.uint8)
        lines += [f"@r{i}", s.tobytes().decode(), "+", q.tobytes().decode()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _native_file(path, k, min_quality=None):
    from krust_tpu_torch.io.format import SequenceFormat
    from krust_tpu_torch.io.reader import parse_to_streams, read_input_bytes

    streams = parse_to_streams(read_input_bytes(path), SequenceFormat.AUTO.resolve(path))
    return NativeEngine().count(streams, k, min_quality)


@pytest.mark.parametrize("k", [1, 16, 17, 32])
@pytest.mark.parametrize("lsm", [False, True], ids=["epoch", "lsm"])
@pytest.mark.parametrize("route", ["flat", "dense"])
@pytest.mark.parametrize("chunk", [64, 700, 1 << 20])
def test_chunked_count_on_cuda_matches_native(dev, tmp_path, monkeypatch, chunk, route,
                                              lsm, k):
    """The bounded-memory ingest path (``ingest_chunk_bytes``) on the card,
    small batches and epochs: the route's codec kernel and K2 launched,
    the table equal to the native core's. Routing is per chunk, so a chunk
    of a few reads may take the other route too (and a FASTQ that ends on
    a record boundary leaves an empty last chunk, fed as one flat batch)."""
    from krust_tpu_torch.api import _count_path

    monkeypatch.setenv("KRUST_EPOCH_ENTRIES", "3000")
    monkeypatch.setenv("KRUST_PENDING_ENTRIES", "5000")
    path = _write_reads_fq(tmp_path / "r.fq", k, 0.002 if route == "flat" else 0.08)
    codec = encode_windows if route == "flat" else encode_dense
    before = {f: f.launches for f in (codec, rle_compact)}
    cfg = EngineConfig(block_windows=256, batch_rows=8, device=dev, ingest_chunk_bytes=chunk,
                       use_epoch_sort=not lsm)
    got = _count_path(path, k, min_quality=20 if route == "dense" else None, config=cfg)
    exp = _native_file(path, k, 20 if route == "dense" else None)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert codec.launches > before[codec]
    assert rle_compact.launches > before[rle_compact]


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_stdin_cli_on_cuda_matches_native(dev, tmp_path, fmt):
    """``python -m krust_tpu_torch 21 -`` on the device engine, reading
    stdin in chunks, prints the native engine's bytes."""
    import os
    import subprocess
    import sys

    path = _write_reads_fq(tmp_path / "r.fq", 7, 0.01)
    if fmt == "fasta":
        recs = open(path).read().splitlines()
        (tmp_path / "r.fa").write_text(
            "".join(f">{h[1:]}\n{s}\n" for h, s in zip(recs[0::4], recs[1::4])))
        path = str(tmp_path / "r.fa")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = []
    for engine in ("device", "native"):
        with open(path, "rb") as stdin:
            outs.append(subprocess.run(
                [sys.executable, "-m", "krust_tpu_torch", "21", "-", "-i", fmt, "-f", "tsv",
                 "-q"], stdin=stdin, capture_output=True, check=True, timeout=300, cwd=repo,
                env=dict(os.environ, KRUST_ENGINE=engine)).stdout)
    assert outs[0] and outs[0] == outs[1]


@pytest.mark.parametrize("k", [5, 21, 32])
def test_kmix_from_device_table_matches_native(dev, tmp_path, k):
    """A ``.kmix`` saved from a table counted on the card has the bytes of
    one saved from the native core's table."""
    from krust_tpu_torch.api import count_with_input
    from krust_tpu_torch.index import KmerIndex, load_index, save_index
    from krust_tpu_torch.io.input import Input

    path = _write_reads_fq(tmp_path / "r.fq", k, 0.01)
    got = count_with_input(Input.from_path(path), k, config=EngineConfig(
        block_windows=256, batch_rows=8, device=dev))
    exp = _native_file(path, k)
    for name, table in (("dev.kmix", got), ("nat.kmix", exp)):
        save_index(KmerIndex.from_arrays(k, table.codes, table.counts), tmp_path / name)
    assert (tmp_path / "dev.kmix").read_bytes() == (tmp_path / "nat.kmix").read_bytes()
    index = load_index(tmp_path / "dev.kmix")
    assert [index.get(int(c)) for c in exp.codes] == exp.counts.tolist()


def test_forms_ch_is_the_kernels_int64_tile(dev):
    """tests/torch_reference_forms.py's CH, the size the loaded kernel
    suites cut their inputs at, is K3's and K2's int64 tile as built."""
    import torch_reference_forms as forms

    from krust_tpu_torch.ops import _cuda

    lib = _cuda.library()
    assert forms.CH == lib.krust_merge_tile(8) == lib.krust_rle_tile(8)


def _pareto_counts(n, seed, dev):
    """n skewed int32 counts on the card, most 1 and a tail past ``BINS``:
    floor(u^(-1/1.5)), a count of 8192 or more about once in 7.4e5."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    return torch.clamp(torch.floor(u.pow(-1 / 1.5)), max=2**31 - 1).to(torch.int32)


@pytest.mark.parametrize("case", ["assembly", "past_bins", "unaligned"])
def test_count_histogram_kernel_matches_plain(dev, case):
    """K6 against its plain version, exactly: ~113M skewed counts (the
    assembly cell's table, with a natural tail past the bins, so the
    overflow launch runs); a million counts, every third one at the bins'
    edge, negative or near 2^31 - 1; and short views
    that start off a 16-byte boundary (the head and tail lanes)."""
    if case == "assembly":
        inputs = [_pareto_counts(112_900_000, 21, dev)]
    elif case == "past_bins":
        c = _pareto_counts(1 << 20, 22, dev)
        odd = torch.tensor([BINS, BINS + 1, 2**31 - 1, -7, BINS - 1, 2**31 - 2],
                           dtype=torch.int32, device=dev)
        c[::3] = odd[torch.arange(c[::3].numel(), device=dev) % odd.numel()]
        inputs = [c]
    else:
        base = _pareto_counts(4096, 23, dev)
        base[5] = 2**31 - 1
        inputs = [base[off:off + n] for off in (1, 2, 3) for n in (1, 3, 5, 31, 33, 1000)]
    for counts in inputs:
        got = count_histogram(counts)
        torch.cuda.synchronize()
        exp = count_histogram_plain(counts.cpu())
        np.testing.assert_array_equal(got.values, exp.values)
        np.testing.assert_array_equal(got.freqs, exp.freqs)
        if case != "unaligned":
            assert int(exp.values[-1]) >= BINS  # the overflow launch ran
            assert int(exp.freqs.sum()) == counts.numel()


@pytest.mark.parametrize("epoch_sort", [True, False], ids=["epoch", "lsm"])
@pytest.mark.parametrize("lifetimes", [1, 3])
def test_count_histogram_launches_once_a_pull(dev, monkeypatch, epoch_sort, lifetimes):
    """Every table pull of a count on the card launches K6 once; one
    lifetime's result carries the histogram (equal to the host's of its
    counts), a count of several carries none."""
    from krust_tpu_torch.histogram import compute_histogram_array

    if lifetimes > 1:
        monkeypatch.setattr(table_mod, "EPOCH_WINDOW_LIMIT", 3 * 8 * 256)
    pulls = []
    pull = table_mod._pull_table
    monkeypatch.setattr(table_mod, "_pull_table", lambda *a: pulls.append(1) or pull(*a))
    s = _sharded_stream(21, False)
    before = count_histogram.launches
    cfg = EngineConfig(block_windows=256, batch_rows=8, device=dev, use_epoch_sort=epoch_sort)
    got = BatchEngine(cfg).count(s, 21)
    exp = NativeEngine().count(s, 21)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert count_histogram.launches - before == len(pulls)
    assert (len(pulls) == 1) == (lifetimes == 1)
    if lifetimes == 1:
        assert compute_histogram_array(got.histogram) == compute_histogram_array(exp.counts)
    else:
        assert got.histogram is None


def _card_table(k, n, dev, seed=5):
    """A finished table on the card: n distinct keys ascending (bit 63 of
    the code set on some at k = 32), counts up to 2^31 - 1, sentinel padding
    past n."""
    g = torch.Generator(device=dev).manual_seed(seed + k)
    dtype = torch.int32 if k <= 16 else torch.int64
    lo, top = torch.iinfo(dtype).min, torch.iinfo(dtype).max  # top: the sentinel
    keys = torch.unique(torch.randint(lo, min(lo + (1 << (2 * k)), top), (n + n // 16,),
                                      generator=g, device=dev, dtype=dtype))[:n]
    assert keys.numel() == n
    counts = torch.randint(1, 9000, (n,), generator=g, device=dev, dtype=torch.int32)
    counts[0] = 2**31 - 1
    pad = 1000
    keys = torch.cat([keys, torch.full((pad,), torch.iinfo(dtype).max, dtype=dtype, device=dev)])
    return keys, torch.cat([counts, torch.zeros(pad, dtype=torch.int32, device=dev)])


@pytest.mark.parametrize("k", [16, 21, 32])
def test_pull_from_the_card_matches_the_cpu_pull(dev, k):
    """A table on the card pulls through the pinned ring to the same bytes
    as the same table pulled on the CPU, histogram included, in
    ceil(entries / chunk) chunks a pull."""
    n = 2 * table_mod.PULL_CHUNK_ENTRIES + 12_345
    t_keys, t_cnt = _card_table(k, n, dev)
    before = table_mod._copy_decode.chunks
    got = table_mod._pull_table(t_keys, t_cnt, n, k)
    assert table_mod._copy_decode.chunks - before == -(-n // table_mod.PULL_CHUNK_ENTRIES)
    exp = table_mod._pull_table(t_keys.cpu(), t_cnt.cpu(), n, k)
    assert got[0].tobytes() == exp[0].tobytes()
    assert got[1].tobytes() == exp[1].tobytes()
    np.testing.assert_array_equal(got.histogram.values, exp.histogram.values)
    np.testing.assert_array_equal(got.histogram.freqs, exp.histogram.freqs)
    if k == 32:
        assert (got[0] >> np.uint64(63)).any()


def test_the_pull_ring_is_reused_and_never_grows(dev):
    """Two pulls of different sizes use the same pinned buffers, at the
    same size, and read their chunks' counter each."""
    small, large = 1000, 3 * table_mod.PULL_CHUNK_ENTRIES + 7
    t_keys, t_cnt = _card_table(21, large, dev)
    table_mod._pull_table(t_keys, t_cnt, small, 21)
    held = [b for slot in table_mod._RING for b in slot]
    buffers = [(id(b), b.data_ptr(), b.numel()) for b in held]
    assert len(held) == 4 and all(b.is_pinned() for b in held)
    before = table_mod._copy_decode.chunks
    got = table_mod._pull_table(t_keys, t_cnt, large, 21)
    assert table_mod._copy_decode.chunks - before == 4
    assert [(id(b), b.data_ptr(), b.numel()) for slot in table_mod._RING for b in slot] == buffers
    assert all(n == table_mod.PULL_CHUNK_ENTRIES for _, _, n in buffers)
    want = table_mod._pull_table(t_keys.cpu(), t_cnt.cpu(), large, 21)
    assert got[0].tobytes() == want[0].tobytes() and got[1].tobytes() == want[1].tobytes()
