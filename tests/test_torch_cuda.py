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

from krust_tpu_torch.io.packer import pack2_full
from krust_tpu_torch.io.reader import ParsedStreams
from krust_tpu_torch.kmer import INVALID_CODE
from krust_tpu_torch.models.engines import BatchEngine, NumpyEngine
from krust_tpu_torch.ops.fused_codec import TAIL_BYTES, encode_windows, encode_windows_plain
from krust_tpu_torch.ops.merge import merge_sorted, merge_sorted_plain
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


@pytest.mark.parametrize("k", [1, 2, 3, 5, 16, 17, 21, 31, 32])
def test_codec_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(11 + k)
    n_windows = 64 * 512
    stream = rng.integers(0, 4, size=n_windows + k - 1, dtype=np.uint8)
    stream[rng.random(stream.shape[0]) < 0.01] = INVALID_CODE
    if k == 32:
        stream[:300] = 2  # canonical 32-mers with bit 63 set
    inv = np.flatnonzero(stream >= INVALID_CODE).astype(np.int32)
    invpos = np.concatenate([inv, np.full(5, stream.shape[0], np.int32)])  # padding
    packed = np.zeros(n_windows // 4 + TAIL_BYTES, np.uint8)
    p = pack2_full(stream)
    packed[: p.shape[0]] = p
    pk = torch.from_numpy(packed).to(dev)
    iv = torch.from_numpy(invpos).to(dev)
    covered = n_windows - 77
    got = encode_windows(pk, iv, covered, k, n_windows)
    assert torch.equal(got, encode_windows_plain(pk, iv, covered, k, n_windows))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 300_001])
def test_rle_kernel_matches_plain(dev, dtype, weighted, n):
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    keys = _sorted_keys(g, n, 1000, dtype, dev, 0.2)
    cnt = (
        torch.randint(1, 50, (n,), generator=g, device=dev, dtype=torch.int32)
        if weighted else None
    )
    for a, b in zip(rle_compact(keys, cnt), rle_compact_plain(keys, cnt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("ma,mb", [(1, 0), (0, 5), (1000, 3), (70_000, 130_001)])
def test_merge_kernel_matches_plain(dev, dtype, ma, mb):
    g = torch.Generator(device=dev)
    g.manual_seed(ma + mb)

    def part(m):
        keys = _sorted_keys(g, m, 5000, dtype, dev, 0.25)
        return keys, torch.randint(0, 9, (m,), generator=g, device=dev, dtype=torch.int32)

    a, b = part(ma), part(mb)
    got = merge_sorted(*a, *b)
    exp = merge_sorted_plain(*a, *b)
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


def test_dense_input_raises_on_cuda(dev):
    """Dirty input counts on the flat kernel path; only a geometry the flat
    layout cannot hold raises (the dense path is ROADMAP A8)."""
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    codes[rng.random(5000) < 0.2] = INVALID_CODE
    s = ParsedStreams(codes, None, 1, 5000)
    with pytest.raises(NotImplementedError, match="A8"):
        BatchEngine(EngineConfig(block_windows=260, device=dev)).count(s, 11)
    before = encode_windows.launches
    got = BatchEngine(EngineConfig(device=dev)).count(s, 11)
    exp = NumpyEngine().count(s, 11)
    np.testing.assert_array_equal(got.codes, exp.codes)
    np.testing.assert_array_equal(got.counts, exp.counts)
    assert encode_windows.launches > before
