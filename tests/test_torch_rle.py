"""Port RLE (krust_tpu_torch.ops.rle) against the JAX package's rle_compact.

Both packages get the same numpy-made key-sorted, sentinel-padded streams;
the JAX kernel runs in interpret mode at the small chunk the test harness
sets (KRUST_RLE_CHUNK), so runs cross chunk boundaries. The port's full
output (keys, counts, sentinel/zero tail, n_unique) converts back to the
JAX planes through ``parts_to_numpy`` and must be equal (tolerance 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krust_tpu.ops import pallas_rle
from krust_tpu_torch.ops.keys import parts_from_numpy, parts_to_numpy
from krust_tpu_torch.ops.rle import rle_compact

SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    yield
    jax.clear_caches()


def _stream(rng, n, n_distinct, bits, pad, weighted):
    codes = np.sort(rng.integers(0, 1 << bits, n_distinct, dtype=np.uint64)[
        rng.integers(0, n_distinct, n)
    ])
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = (codes & np.uint64(SENT)).astype(np.uint32)
    hi = np.concatenate([hi, np.full(pad, SENT, np.uint32)])
    lo = np.concatenate([lo, np.full(pad, SENT, np.uint32)])
    cnt = None
    if weighted:
        cnt = np.concatenate(
            [rng.integers(1, 1000, n).astype(np.uint32), np.zeros(pad, np.uint32)]
        )
    return hi, lo, cnt


def _compare(hi, lo, cnt, one_key):
    k = 16 if one_key else 32
    jargs = [None if one_key else jnp.asarray(hi), jnp.asarray(lo)]
    if cnt is not None:
        jargs.append(jnp.asarray(cnt))
    e_hi, e_lo, e_cnt, e_n = pallas_rle.rle_compact(*jargs, interpret=True, one_key=one_key)

    keys, counts = parts_from_numpy(hi, lo, np.zeros_like(lo) if cnt is None else cnt, k)
    o_keys, o_cnt, n_u = rle_compact(keys, None if cnt is None else counts)
    assert int(n_u.item()) == int(e_n)
    g_hi, g_lo, g_cnt = parts_to_numpy(o_keys, o_cnt, k)
    np.testing.assert_array_equal(g_lo, np.asarray(e_lo))
    np.testing.assert_array_equal(g_cnt, np.asarray(e_cnt))
    np.testing.assert_array_equal(g_hi, np.asarray(e_hi))


# one padded length (N) for every case: one interpret-mode compile per mode
N = 4096


@pytest.mark.parametrize("one_key", [False, True], ids=["two_key", "one_key"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("n,n_distinct", [(1, 1), (1500, 40), (2996, 700), (N, 2000)])
def test_rle_matches_pallas(one_key, weighted, n, n_distinct):
    pad = N - n
    rng = np.random.default_rng(n + 2 * weighted + one_key)
    bits = 32 if one_key else 50
    hi, lo, cnt = _stream(rng, n, n_distinct, bits, pad, weighted)
    if one_key:  # k <= 16 keys live in lo; hi is all-zero/SENT
        hi = np.where(lo == SENT, SENT, 0).astype(np.uint32)
    _compare(hi, lo, cnt, one_key)


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
def test_single_run_spanning_chunks(weighted):
    """One key repeated across several 1024-entry chunks."""
    codes = np.full(N, 123456789012, np.uint64)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    lo = (codes & np.uint64(SENT)).astype(np.uint32)
    cnt = np.arange(1, N + 1, dtype=np.uint32) if weighted else None
    _compare(hi, lo, cnt, False)


@pytest.mark.parametrize("one_key", [False, True], ids=["two_key", "one_key"])
def test_all_sentinel(one_key):
    hi = np.full(N, SENT, np.uint32)
    lo = np.full(N, SENT, np.uint32)
    _compare(hi, lo, None, one_key)
    keys, _ = parts_from_numpy(hi, lo, np.zeros(N, np.uint32), 16 if one_key else 32)
    o_keys, o_cnt, n_u = rle_compact(keys)
    assert int(n_u.item()) == 0 and int(o_cnt.abs().sum()) == 0


def test_empty():
    keys = torch.zeros(0, dtype=torch.int64)
    o_keys, o_cnt, n_u = rle_compact(keys)
    assert o_keys.numel() == 0 and o_cnt.numel() == 0 and int(n_u.item()) == 0

